"""PyTorch port (simseg_tpu_torch): the native decode library
(``data/native.py`` over its copy of ``data/_native/decode.cc``) against the
JAX package's (``simseg_tpu/data/native.py``), both built here from the
same source, and the pipelines' native head
(``TransformPipeline.from_bytes`` / ``load``) and the datasets that read
through it against JAX's under the default config (``data.native_decode``
on).

Bar: bit-equal throughout (the same C++ code, the same random draws under
the same ``random.seed``). The fallback (``SIMSEG_NATIVE=0``, the flag off,
a head that does not fold) gives the port's reader path, which equals
JAX's PIL path.
"""

import os
import random
from io import BytesIO

import numpy as np
import pytest
import torch
from PIL import Image

import simseg_tpu.data.datasets as jax_ds
from simseg_tpu.data import native as jax_native
from simseg_tpu.data.transforms import build_transforms as jax_build_transforms
from simseg_tpu_torch.data import native
import simseg_tpu_torch.data.datasets as ds
from simseg_tpu_torch.data.transforms import build_transforms
from tests.test_torch_port_pair_data import (assert_batches_equal, cfgs,
                                             tokenizers, write_pair_set)

torch.set_num_threads(1)

# the default config's data path: the native head on (cfgs() sets it off)
NATIVE = ("data.native_decode=True",)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries built here (g++, libjpeg, libpng, libwebp), else skip,
    as JAX's own native tests do (``tests/test_native_decode.py:16``)."""
    if not (native.available() and jax_native.available()):
        pytest.skip(f"the native decode library does not build here: "
                    f"{native.build_error()}")


def _image(w, h, seed, mode="RGB"):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(h // 6, 1), max(w // 6, 1), 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if mode == "RGBA":
        alpha = rng.integers(0, 256, (h, w), np.uint8)
        img = Image.fromarray(np.dstack([np.asarray(img), alpha]), "RGBA")
    elif mode != "RGB":
        img = img.convert(mode)
    return img


def _encode(img, fmt, **kw):
    buf = BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


ENCODED = {
    "jpeg": lambda: _encode(_image(320, 240, 0), "JPEG", quality=90),
    "jpeg_420_odd": lambda: _encode(_image(257, 131, 1), "JPEG", quality=75),
    "jpeg_grey": lambda: _encode(_image(200, 150, 2, "L"), "JPEG"),
    "png": lambda: _encode(_image(150, 100, 3), "PNG"),
    "png_rgba": lambda: _encode(_image(97, 61, 4, "RGBA"), "PNG"),
    "png_grey": lambda: _encode(_image(64, 80, 5, "L"), "PNG"),
    "png_palette": lambda: _encode(_image(70, 50, 6, "P"), "PNG"),
}

DECODES = {
    "full_exact": dict(fast_scale=False),
    "full_fast": dict(fast_scale=True),
    "dct_scaled": dict(out_size=(40, 30), fast_scale=True),
    "bilinear": dict(out_size=(96, 72), filter=native.FILTER_BILINEAR,
                     fast_scale=False),
    "bicubic": dict(out_size=(96, 72), filter=native.FILTER_BICUBIC,
                    fast_scale=False),
    "nearest": dict(out_size=(96, 72), filter=native.FILTER_NEAREST,
                    fast_scale=False),
    "crop_resize_flip": dict(crop=(7, 5, 41, 33), out_size=(24, 24), flip=True),
    "crop_only": dict(crop=(3, 2, 30, 20)),
    "crop_past_edge": dict(crop=(20, 10, 500, 500), fast_scale=False),
}


@pytest.mark.parametrize("fmt", list(ENCODED))
@pytest.mark.parametrize("how", list(DECODES))
def test_decode_matches_jax(fmt, how):
    data = ENCODED[fmt]()
    kw = DECODES[how]
    got = native.decode(data, **kw)
    want = jax_native.decode(data, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_lossless_decodes_are_pil_and_the_port_reader():
    """PNG of every mode and a full exact JPEG equal PIL's RGB pixels; PNG
    equals the port's own reader (``data/image_io.py``)."""
    from simseg_tpu_torch.data.image_io import decode_rgb

    for fmt in ("jpeg", "png", "png_rgba", "png_grey", "png_palette"):
        data = ENCODED[fmt]()
        got = native.decode(data, fast_scale=False)
        want = np.asarray(Image.open(BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(got, want, err_msg=fmt)
        if fmt.startswith("png"):
            np.testing.assert_array_equal(got, decode_rgb(data, "cpu").numpy(),
                                          err_msg=fmt)


def test_image_size_and_bad_input():
    for fmt in ENCODED:
        data = ENCODED[fmt]()
        assert native.image_size(data) == jax_native.image_size(data) == \
            Image.open(BytesIO(data)).size
    with pytest.raises(ValueError):
        native.image_size(b"not an image at all....")
    with pytest.raises(ValueError):
        native.decode(ENCODED["jpeg"]()[:200], fast_scale=False)


def test_batch_decoder_matches_jax_and_single_calls():
    datas = [ENCODED[f]() for f in ENCODED]
    crops = [(i, 2 * i, 50 + i, 40) for i in range(len(datas))]
    flips = [i % 2 == 0 for i in range(len(datas))]
    got = native.BatchDecoder(3).decode_batch(datas, 48, 40, crops=crops,
                                              flips=flips)
    want = jax_native.BatchDecoder(3).decode_batch(datas, 48, 40, crops=crops,
                                                   flips=flips)
    np.testing.assert_array_equal(got, want)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(got[i], native.decode(
            d, crop=crops[i], out_size=(48, 40), flip=flips[i]))
    with pytest.raises(ValueError, match="indices \\[1\\]"):
        native.BatchDecoder(2).decode_batch([datas[0], b"junk" * 10], 8, 8)


def test_library_builds_into_the_build_directory():
    path = native.library_path()
    assert os.path.dirname(path).endswith(os.path.join("simseg_tpu_torch", "_build"))
    assert os.path.exists(path) and native.build_error() is None
    with open(native.SOURCE, "rb") as a, open(
            os.path.join(os.path.dirname(jax_native.__file__), "_native",
                         "decode.cc"), "rb") as b:
        assert a.read() == b.read()


# --------------------------------------------------------------- pipelines

PIPELINES = {
    # (mode, transform overrides): every head the planner folds
    "train_rrc_flip": ("train", ()),
    "train_rrc_autoaug": ("train", (
        "transforms.train_transforms=[random_resize_crop,autoaug,random_flip]",)),
    "train_random_crop": ("train", (
        "transforms.train_transforms=[random_crop,random_flip,color_jitter]",
        "transforms.random_crop.size=48")),
    "train_resize": ("train", ("transforms.train_transforms=[resize]",)),
    "valid_resize": ("valid", ()),
    "valid_bicubic_center": ("valid", (
        "transforms.valid_transforms=[resize_bicubic,center_crop]",
        "transforms.resize_bicubic.size=40", "transforms.center_crop.size=32")),
    "valid_center_first": ("valid", (
        "transforms.valid_transforms=[center_crop]",
        "transforms.center_crop.size=64")),
}


def _pipelines(tmp_path, name, *extra):
    mode, argv = PIPELINES[name]
    cfg, jcfg = cfgs(tmp_path, *NATIVE, *argv, *extra)
    return mode, build_transforms(cfg, mode), jax_build_transforms(jcfg, mode)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_load_matches_jax(tmp_path, name):
    """``load`` of JPEGs and PNGs (one too small for the 64-px centre crop,
    which falls back) against JAX's ``load`` at one seed per image, the
    generators left in the same state."""
    mode, port, ref = _pipelines(tmp_path, name)
    for i, fmt in enumerate(ENCODED):
        path = tmp_path / f"img{i}"
        path.write_bytes(ENCODED[fmt]())
        random.seed(i)
        np.random.seed(i)
        want = ref.load(str(path))
        states = random.getstate(), np.random.get_state()[1].copy()
        random.seed(i)
        np.random.seed(i)
        got = port.load(str(path))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fmt)
        assert random.getstate() == states[0], fmt
        np.testing.assert_array_equal(np.random.get_state()[1], states[1])


@pytest.mark.parametrize("how", ["env", "flag"])
def test_fallback_is_the_reader_path(tmp_path, monkeypatch, how):
    """``SIMSEG_NATIVE=0`` (the library unloaded) or
    ``data.native_decode=False``: ``load`` is the port's reader and the
    ops, equal to JAX's PIL path."""
    if how == "env":
        monkeypatch.setenv("SIMSEG_NATIVE", "0")
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_lib", None)
        assert not native.available()
        assert native.build_error() == "SIMSEG_NATIVE=0"
        extra = NATIVE
    else:
        extra = ("data.native_decode=False",)
    cfg, jcfg = cfgs(tmp_path, *extra)
    port = build_transforms(cfg, "train")
    ref = jax_build_transforms(cfgs(tmp_path)[1], "train")   # JAX's PIL path
    assert (port._head is None) == (how == "flag")
    for i, fmt in enumerate(("jpeg", "png")):
        data = ENCODED[fmt]()
        random.seed(i)
        want = ref(Image.open(BytesIO(data)).convert("RGB"))
        random.seed(i)
        np.testing.assert_array_equal(port.from_bytes(data).numpy(), want)
    monkeypatch.undo()
    native._tried = False
    assert native.available() and native.build_error() is None


def test_default_data_path_differs_from_the_reader_path(tmp_path):
    """What the repair changed: under the default config JAX's train
    batches come from the native head (DCT-scaled JPEG, its own resample),
    not from the reader path the port used before; the two differ."""
    _, port_native, _ = _pipelines(tmp_path, "train_resize")
    cfg, _ = cfgs(tmp_path, "transforms.train_transforms=[resize]")
    reader = build_transforms(cfg, "train")
    data = ENCODED["jpeg"]()
    a = port_native.from_bytes(data).numpy().astype(np.int16)
    b = reader.from_bytes(data).numpy().astype(np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() > 0


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("mode", ["train", "valid"])
def test_csv_pair_dataset_default_config_matches_jax(tmp_path, mode):
    write_pair_set(tmp_path, "set", 10, 7, seed=4)
    port_tok, jax_tok = tokenizers()
    cfg, jcfg = cfgs(tmp_path, *NATIVE)
    assert cfg.data.native_decode and jcfg.data.native_decode
    port = ds.CsvPairDataset(cfg, "set", port_tok, build_transforms(cfg, mode),
                             mode)
    ref = jax_ds.CsvPairDataset(jcfg, "set", jax_tok,
                                jax_build_transforms(jcfg, mode), mode)
    samples, jsamples = [], []
    for i in range(len(ref)):
        random.seed(i)
        jsamples.append(ref[i])
        random.seed(i)
        samples.append(port[i])
    assert_batches_equal(ds._collate(samples), jax_ds._collate(jsamples))


def _write_folders(root, seed=5):
    rng = np.random.default_rng(seed)
    for c in ("ant", "bee", "cat"):
        (root / c).mkdir(parents=True)
        for i in range(3):
            h, w = (int(v) for v in rng.integers(40, 91, 2))
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            img.save(root / c / f"{i}.{'png' if i == 1 else 'jpg'}")


@pytest.mark.parametrize("mode", ["train", "valid"])
def test_image_folder_dataset_default_config_matches_jax(tmp_path, mode):
    _write_folders(tmp_path / "train")
    cfg, jcfg = cfgs(tmp_path, *NATIVE)
    port = ds.ImageFolderDataset(str(tmp_path / "train"),
                                 build_transforms(cfg, mode))
    ref = jax_ds.ImageFolderDataset(str(tmp_path / "train"),
                                    jax_build_transforms(jcfg, mode))
    samples, jsamples = [], []
    for i in range(len(ref)):
        random.seed(i)
        jsamples.append(ref[i])
        random.seed(i)
        samples.append(port[i])
    assert_batches_equal(ds._collate(samples), jax_ds._collate(jsamples))
