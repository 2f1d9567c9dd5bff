"""PyTorch port (simseg_tpu_torch): the files the port's own readers do not
take, read as JAX reads them (``data/image_io.py``).

JAX opens every file with PIL (``simseg_tpu/data/datasets.py:95, 136,
189, 197-198, 225``). The port routes each file by its header before any
decode (``image_io.decoder_of``): the port's PNG reader, nvJPEG on the
card, else PIL on the host. One seeded image is written as GIF, lossless
WebP, BMP, TIFF, a 16-bit grey PNG, an Adam7-interlaced PNG, a 4:1:1
JPEG (``simseg_tpu_torch/data/_testdata/sampling_411.jpg``, which PIL
cannot write) and an RGB JPEG that says so only by its component IDs;
each goes through the port's CSV, parquet, ImageFolder and
seg datasets and through JAX's on the same file, with no valid transform:
the decoded pixels bit-equal. A 16-bit and an interlaced label PNG give
JAX's label array. The route is counted: those formats take PIL, a PNG
the port's reader and a 4:2:0 JPEG nvJPEG for a card caller (the card's
decode itself is held against PIL in ``chip_smoke.py``, 16c).
"""

import csv
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import simseg_tpu.data.datasets as jax_ds
from simseg_tpu.data.transforms import build_transforms as jax_build_transforms
import simseg_tpu_torch.data.datasets as ds
from simseg_tpu_torch.data import image_io
from simseg_tpu_torch.data.transforms import build_transforms
from tests.test_torch_port_image_io import _chunk
from tests.test_torch_port_pair_data import cfgs, tokenizers

torch.set_num_threads(1)

TESTDATA = os.path.join(os.path.dirname(image_io.__file__), "_testdata")


def _image():
    rng = np.random.default_rng(21)
    return rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)


# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)]


def interlaced_png(grey: np.ndarray) -> bytes:
    """An 8-bit grey PNG written in Adam7's seven passes (PIL writes no
    interlaced PNG), each row with filter 0."""
    h, w = grey.shape
    raw = b""
    for r0, c0, dr, dc in _ADAM7:
        sub = grey[r0::dr, c0::dc]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def encoded(fmt: str) -> bytes:
    """The seeded image in ``fmt``."""
    img = _image()
    buf = io.BytesIO()
    if fmt == "gif":
        Image.fromarray(img).save(buf, format="GIF")
    elif fmt == "webp":
        Image.fromarray(img).save(buf, format="WEBP", lossless=True)
    elif fmt == "bmp":
        Image.fromarray(img).save(buf, format="BMP")
    elif fmt == "tiff":
        Image.fromarray(img).save(buf, format="TIFF")
    elif fmt == "png16":
        grey = img[..., 0].astype(np.uint16) * 257
        Image.fromarray(grey).save(buf, format="PNG")
    elif fmt == "interlaced":
        return interlaced_png(img[..., 1])
    elif fmt == "jpeg_rgb":
        # RGB components named 'R', 'G', 'B', with the Adobe marker that
        # PIL writes beside them cut out
        Image.fromarray(img).save(buf, format="JPEG", keep_rgb=True, quality=95)
        data = buf.getvalue()
        assert data[2:4] == b"\xff\xee"
        return data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]
    elif fmt == "jpeg411":
        with open(os.path.join(TESTDATA, "sampling_411.jpg"), "rb") as f:
            return f.read()
    elif fmt == "png":
        Image.fromarray(img).save(buf, format="PNG")
    elif fmt == "jpeg420":
        Image.fromarray(img).save(buf, format="JPEG", subsampling=2, quality=90)
    return buf.getvalue()


OTHER = ["gif", "webp", "bmp", "tiff", "png16", "interlaced", "jpeg411",
         "jpeg_rgb"]
OWN = {"png": "png", "jpeg420": "nvjpeg"}


def test_the_files_are_what_they_claim():
    """Each file is the format named (the 16-bit PNG's depth, the
    interlace flag, the 4:1:1 sampling, the RGB JPEG's IDs and no Adobe
    marker, read from their headers), and PIL reads it at the image's
    size, the RGB JPEG as RGB."""
    assert encoded("png16")[24] == 16
    assert encoded("interlaced")[28] == 1
    frame = image_io._jpeg_frame(encoded("jpeg411"))
    assert frame[2] == [(4, 1), (1, 1), (1, 1)]
    frame = image_io._jpeg_frame(encoded("jpeg_rgb"))
    assert frame[2:] == ([(1, 1)] * 3, None, [82, 71, 66])
    with Image.open(io.BytesIO(encoded("jpeg_rgb"))) as im:
        assert np.abs(np.asarray(im.convert("RGB"), np.int32)
                      - _image()).mean() < 4
    for fmt in OTHER:
        with Image.open(io.BytesIO(encoded(fmt))) as im:
            assert im.size == (40, 24), fmt


@pytest.fixture
def count_routes(monkeypatch):
    """Calls of each decoder of ``image_io``; nvJPEG's is stubbed with
    PIL's pixels (no card here), reached by routing a 'cuda' caller."""
    calls = {"png": 0, "nvjpeg": 0, "pil": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    pil = image_io._pil_rgb
    monkeypatch.setattr(image_io, "_png_rgb", counted("png", image_io._png_rgb))
    monkeypatch.setattr(image_io, "_pil_rgb", counted("pil", pil))
    monkeypatch.setattr(image_io, "_nvjpeg_rgb", counted(
        "nvjpeg", lambda data, device: torch.from_numpy(pil(data))))
    return calls


@pytest.mark.parametrize("fmt", OTHER + list(OWN))
def test_the_route_is_read_from_the_header(fmt, count_routes, monkeypatch):
    """CPU and card callers: every file of ``OTHER`` decodes through PIL
    alone, equal to ``Image.open(...).convert("RGB")``; a PNG through the
    port's reader and a 4:2:0 JPEG through nvJPEG for a card caller (PIL
    for a CPU one), each once."""
    data = encoded(fmt)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    got = image_io.decode_rgb(data, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(image_io, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    card = image_io.decode_rgb(data, "cuda")
    np.testing.assert_array_equal(card.numpy(), want)
    route = OWN.get(fmt, "pil")
    cpu_route = "png" if fmt == "png" else "pil"
    expect = {"png": 0, "nvjpeg": 0, "pil": 0}
    expect[cpu_route] += 1
    expect[route] += 1
    assert count_routes == expect
    assert image_io.decoder_of(data, "cuda") == route
    assert image_io.decoder_of(data, "cpu") == cpu_route


def _write_sets(root):
    """Every format under one name in each dataset layout: the CSV set
    (``fmt/valid/<fmt>.img``), its parquet, class folders and a
    VOC-layout seg split (images as ``<fmt>.jpg``, labels ``<fmt>.png``: a
    16-bit and an interlaced PNG, and plain ones)."""
    names = OTHER + list(OWN)
    base = root / "fmt"
    (base / "valid").mkdir(parents=True)
    rows = []
    for i, fmt in enumerate(names):
        (base / "valid" / f"{fmt}.img").write_bytes(encoded(fmt))
        rows.append([f"{fmt}.img", "a photo of the dog", str(i), str(100 + i)])
    with open(base / "valid_anno.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "caption", "image_id", "caption_id"])
        w.writerows(rows)
    import pandas as pd

    pd.DataFrame([{"imbytes": encoded(fmt), "caption": "a cat", "image_id": i,
                   "id": i} for i, fmt in enumerate(names)]
                 ).to_parquet(base / "valid.parquet")
    for fmt in names:
        (root / "folders" / fmt).mkdir(parents=True)
        (root / "folders" / fmt / "x.img").write_bytes(encoded(fmt))
    voc = root / "VOCdevkit" / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (voc / d).mkdir(parents=True)
    labels = {"png16": encoded("png16"), "interlaced": encoded("interlaced")}
    for fmt in names:
        (voc / "JPEGImages" / f"{fmt}.jpg").write_bytes(encoded(fmt))
        label = labels.get(fmt)
        if label is None:
            buf = io.BytesIO()
            Image.fromarray((_image()[..., 2] % 21).astype(np.uint8)).save(
                buf, format="PNG")
            label = buf.getvalue()
        (voc / "SegmentationClass" / f"{fmt}.png").write_bytes(label)
    (voc / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(names))
    return names


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    names = _write_sets(root)
    ours, ref = cfgs(root, "transforms.valid_transforms=[]")
    return root, names, ours, ref


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_csv_and_parquet_datasets_read_as_jax(sets):
    root, names, ours, ref = sets
    tok, jtok = tokenizers()
    port = ds.CsvPairDataset(ours, "fmt", tok, build_transforms(ours, "valid"),
                             mode="valid")
    jax = jax_ds.CsvPairDataset(ref, "fmt", jtok,
                                jax_build_transforms(ref, "valid"), mode="valid")
    pq_port = ds.ParquetRetrievalDataset(ours, "fmt", tok,
                                         build_transforms(ours, "valid"))
    pq_jax = jax_ds.ParquetRetrievalDataset(ref, "fmt", jtok,
                                            jax_build_transforms(ref, "valid"))
    for i, fmt in enumerate(names):
        _equal(port[i]["image"], jax[i]["image"], f"csv {fmt}")
        _equal(pq_port[i]["image"], pq_jax[i]["image"], f"parquet {fmt}")


def test_image_folder_dataset_reads_as_jax(sets):
    root, names, ours, ref = sets
    port = ds.ImageFolderDataset(str(root / "folders"),
                                 build_transforms(ours, "valid"))
    jax = jax_ds.ImageFolderDataset(str(root / "folders"),
                                    jax_build_transforms(ref, "valid"))
    assert [s[1] for s in port.samples] == [s[1] for s in jax.samples]
    for i in range(len(port)):
        _equal(port[i]["image"], jax[i]["image"], port.samples[i][0])


def test_seg_dataset_reads_images_and_labels_as_jax(sets):
    """Images of every format and the 16-bit and interlaced label PNGs:
    pixels, label arrays (int32, JAX's values) and the label sizes."""
    root, names, ours, ref = sets
    port = ds.SegDataset(ours, "pascal_voc", build_transforms(ours, "valid"),
                         device="cpu")
    jax = jax_ds.SegDataset(ref, "pascal_voc", jax_build_transforms(ref, "valid"))
    assert port.max_label_size() == jax.max_label_size() == (24, 40)
    for i, fmt in enumerate(names):
        got, want = port[i], jax[i]
        _equal(got["image"], want["image"], f"seg image {fmt}")
        _equal(got["mask_label"], want["mask_label"], f"seg label {fmt}")
    png16 = port[names.index("png16")]["mask_label"]
    assert png16.max() > 255   # the 16-bit values, as np.asarray(Image.open) has them


@pytest.mark.parametrize("fmt", ["png16", "interlaced"])
def test_label_reader_gives_pils_array(fmt, tmp_path):
    """``read_label_array`` and ``image_size`` on a 16-bit and an
    interlaced PNG: ``np.asarray(Image.open(path))`` (dtype, shape,
    values) and PIL's size."""
    path = tmp_path / f"{fmt}.png"
    path.write_bytes(encoded(fmt))
    with Image.open(path) as im:
        want = np.asarray(im)
        size = im.size
    got = image_io.read_label_array(path.read_bytes())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert image_io.image_size(str(path)) == size
