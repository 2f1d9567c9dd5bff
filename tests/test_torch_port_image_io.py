"""PyTorch port (simseg_tpu_torch): the port's PNG reader and its decode,
held against PIL (which the JAX package decodes with,
``simseg_tpu/data/datasets.py:189, :197-198``).

Files are written here with every colour type the reader takes (L, P,
RGB, LA, RGBA), bit depths 1, 2, 4 and 8, and each row's filter drawn from
the five PNG filters, so that every unfilter path runs. Bars: bit-equal
to PIL for ``np.asarray(Image.open(f))`` (dtype, shape and values) and for
``.convert("RGB")``; header sizes equal to PIL's; interlaced and 16-bit
files refused by the reader with a reason, and routed to PIL by their
header (``tests/test_torch_port_image_formats.py`` holds that route
against JAX). The committed JPEG decodes on the CPU equal to the PIL
pixels committed beside it.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from simseg_tpu_torch.data import image_io

torch.set_num_threads(1)

TESTDATA = os.path.join(os.path.dirname(image_io.__file__), "_testdata")
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """PNG row filtering (None, Sub, Up, Average, Paeth) of packed rows."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row, f in zip(rows.astype(np.int32), ftypes):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([int(f)]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(samples, depth, colour, ftypes, palette=None, interlace=0,
              file_depth=None) -> bytes:
    """A PNG of (H, W[, c]) samples at ``depth`` bits, row filters ftypes."""
    h, w = samples.shape[:2]
    ch = CHANNELS[colour]
    rows = samples.reshape(h, w * ch).astype(np.int64)
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.int64)
        padded[:, :w] = rows
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (padded.reshape(h, -1, per) << shifts).sum(-1)
    ihdr = struct.pack(">IIBBBBB", w, h, file_depth or depth, colour, 0, 0,
                       interlace)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    raw = _filter_rows(rows.astype(np.uint8), max(1, ch * depth // 8), ftypes)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@st.composite
def png_files(draw):
    colour = draw(st.sampled_from([0, 2, 3, 4, 6]))
    depth = 8 if colour in (2, 4, 6) else draw(st.sampled_from([1, 2, 4, 8]))
    h = draw(st.integers(1, 24))
    w = draw(st.integers(1, 37))
    seed = draw(st.integers(0, 2 ** 31))
    rng = np.random.default_rng(seed)
    ch = CHANNELS[colour]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, ch) if ch > 1 else (h, w))
    palette = None
    if colour == 3:
        # may be shorter than the largest index: PIL reads black past it
        palette = rng.integers(0, 256, (int(rng.integers(1, top + 2)), 3))
    ftypes = rng.integers(0, 5, h)
    return write_png(samples, depth, colour, ftypes, palette), colour, depth


@settings(max_examples=150, deadline=None, derandomize=True)
@given(png_files())
def test_png_reader_matches_pil(case):
    data, colour, depth = case
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
        want_rgb = np.asarray(im.convert("RGB"))
        want_size = im.size
    got = image_io.read_png_array(data)
    assert got.dtype == want.dtype and got.shape == want.shape, (colour, depth)
    np.testing.assert_array_equal(got, want)
    got_rgb = image_io.decode_rgb(data, "cpu")
    assert got_rgb.dtype == torch.uint8 and got_rgb.device.type == "cpu"
    np.testing.assert_array_equal(got_rgb.numpy(), want_rgb)
    assert image_io.image_format(data) == "png"
    assert tuple(got.shape[1::-1]) == want_size


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_alone_on_rgb_rows(ftype):
    """Every row through one filter: the wavefront unfilter at a width
    where pixels of many rows are in flight together."""
    rng = np.random.default_rng(ftype)
    samples = rng.integers(0, 256, (40, 53, 3))
    data = write_png(samples, 8, 2, [ftype] * 40)
    np.testing.assert_array_equal(image_io.read_png_array(data),
                                  samples.astype(np.uint8))


def test_pil_written_files_and_header_size(tmp_path):
    """Files PIL writes itself (its own filter choice, palette labels
    as VOC stores them): the reader and ``image_size`` agree with PIL."""
    rng = np.random.default_rng(7)
    cases = {
        "rgb": Image.fromarray(rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)),
        "grey": Image.fromarray(rng.integers(0, 256, (21, 12), dtype=np.uint8)),
        "rgba": Image.fromarray(rng.integers(0, 256, (9, 30, 4), dtype=np.uint8)),
        "label": Image.fromarray(rng.integers(0, 21, (41, 29), dtype=np.uint8)
                                 ).convert("P"),
    }
    for name, im in cases.items():
        path = tmp_path / f"{name}.png"
        im.save(path)
        data = path.read_bytes()
        with Image.open(path) as ref:
            np.testing.assert_array_equal(image_io.read_png_array(data),
                                          np.asarray(ref), err_msg=name)
            np.testing.assert_array_equal(image_io.decode_rgb(data, "cpu").numpy(),
                                          np.asarray(ref.convert("RGB")),
                                          err_msg=name)
            assert image_io.image_size(str(path)) == ref.size


def test_interlaced_and_16_bit_files_raise():
    """The port's reader refuses both with a reason; their IHDR sends them
    to PIL before any decode, so ``decode_rgb`` never reaches that
    refusal."""
    samples = np.zeros((4, 4), np.int64)
    interlaced = write_png(samples, 8, 0, [0] * 4, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        image_io.read_png_array(interlaced)
    deep = write_png(samples, 8, 0, [0] * 4, file_depth=16)
    with pytest.raises(ValueError, match="16-bit"):
        image_io.read_png_array(deep)
    for data in (interlaced, deep):
        assert image_io.decoder_of(data, "cpu") == "pil"
    assert image_io.decoder_of(write_png(samples, 8, 0, [0] * 4), "cpu") == "png"


def test_unknown_format_raises():
    """A file no reader can open raises PIL's error (it is PIL's to read,
    as in JAX), a broken GIF included."""
    for data in (b"GIF89a" + bytes(20), b"not an image at all"):
        assert image_io.decoder_of(data, "cpu") == "pil"
        with pytest.raises(OSError):
            image_io.decode_rgb(data, "cpu")


def test_committed_jpeg_decodes_as_pil_on_the_cpu():
    """The card's nvJPEG is held against these pixels in chip_smoke.py; on
    the CPU the decode is PIL's, equal to the committed array."""
    with open(os.path.join(TESTDATA, "scene.jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(TESTDATA, "scene_pil.npy"))
    assert image_io.image_format(data) == "jpeg"
    np.testing.assert_array_equal(image_io.decode_rgb(data, "cpu").numpy(), want)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)


def test_cuda_jpeg_decode_needs_the_card():
    """The device the caller names chooses the decoder: without a card a
    CUDA decode raises, it does not fall back to PIL."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py holds nvJPEG")
    with open(os.path.join(TESTDATA, "scene.jpg"), "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match="CUDA"):
        image_io.decode_rgb(data, "cuda")


def _upsample_loops(c, fy, fx):
    """libjpeg's h2v2 / h2v1 fancy upsampling (jdsample.c), transcribed
    loop for loop, edge rows and columns clamped as its context rows are."""
    h, w = c.shape
    c = c.astype(np.int64)
    out = np.zeros((h * fy, w * fx), np.int64)
    for r in range(h):
        for v in range(fy):
            if fy == 2:
                near = c[max(r - 1, 0)] if v == 0 else c[min(r + 1, h - 1)]
                cs = c[r] * 3 + near
            else:
                cs = c[r]
            row = out[r * fy + v]
            for i in range(w):
                last, nxt = cs[max(i - 1, 0)], cs[min(i + 1, w - 1)]
                if fy == 2:
                    row[2 * i] = (cs[i] * 3 + last + 8) >> 4
                    row[2 * i + 1] = (cs[i] * 3 + nxt + 7) >> 4
                else:
                    row[2 * i] = (cs[i] * 3 + last + 1) >> 2
                    row[2 * i + 1] = (cs[i] * 3 + nxt + 2) >> 2
    return out.astype(np.uint8)


@pytest.mark.parametrize("fy,fx", [(2, 2), (1, 2)])
def test_libjpeg_upsample_matches_its_loops(fy, fx):
    rng = np.random.default_rng(fy * 10 + fx)
    for h, w in ((1, 3), (5, 7), (17, 4), (8, 9)):
        plane = rng.integers(0, 256, (h, w)).astype(np.uint8)
        want = _upsample_loops(plane, fy, fx)
        for height, width in ((h * fy, w * fx), (h * fy - 1, w * fx - 1)):
            got = image_io.libjpeg_upsample(torch.from_numpy(plane), fy, fx,
                                            height, width)
            np.testing.assert_array_equal(got.numpy(), want[:height, :width])


@pytest.mark.parametrize("subsampling", [0, 2])
def test_libjpeg_colour_conversion_matches_pil(subsampling):
    """PIL's YCbCr draft decode (libjpeg's upsampled planes, before its
    colour conversion) converted by ``libjpeg_ycc_to_rgb`` equals PIL's RGB
    decode bit for bit (4:4:4 and 4:2:0 files)."""
    rng = np.random.default_rng(subsampling)
    img = Image.fromarray(rng.integers(0, 256, (37, 51, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=85, subsampling=subsampling)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        want = np.asarray(im.convert("RGB"))
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        im.draft("YCbCr", im.size)
        ycc = torch.from_numpy(np.array(im))
    got = image_io.libjpeg_ycc_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2])
    np.testing.assert_array_equal(got.numpy(), want)
