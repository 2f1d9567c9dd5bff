"""Image decoding without PIL on the card where it can (counterpart of the
PIL decode in ``simseg_tpu/data/datasets.py:95, 136, 189, 197-198, 225``
and of ``data/native.py``).

The format is sniffed from the file's first bytes, as PIL does, not from
its name: a ``.jpg`` may hold PNG content. The decoder is chosen from the
header, before any decode (``decoder_of``), never by catching an error:

- **PNG** of 1/2/4/8 bits, not interlaced, is read by the port's own
  reader (``zlib`` and numpy) on every device: colour types L, P, RGB, LA
  and RGBA, the five row filters. ``read_png_array`` gives what
  ``np.asarray(Image.open(p))`` gives (palette indices for P, bool for
  1-bit grey, 2- and 4-bit grey scaled to 0-255); ``decode_rgb`` gives
  ``Image.open(p).convert("RGB")`` (the palette looked up, grey
  replicated, alpha dropped).
- **JPEG** is decoded by PIL for a CPU caller (the library the JAX package
  decodes with) and by nvJPEG for a CUDA caller (``csrc/nvjpeg_decode.cu``,
  linked against the CUDA toolkit's ``libnvjpeg``, built at first use):
  nvJPEG's IDCT gives the component planes, and libjpeg's chroma
  upsampling and integer colour conversion (``libjpeg_upsample``,
  ``libjpeg_ycc_to_rgb``) finish them on the card, so only the IDCT's
  rounding differs from PIL. nvJPEG takes the 8-bit Huffman JPEGs (SOF0-2)
  of one component or of three YCbCr components at 4:4:4, 4:2:2 or 4:2:0,
  read from the SOF segment's sampling factors. ``NVJPEG_DECODES`` counts
  the nvJPEG decodes.
- **Everything else** (GIF, WebP, BMP, TIFF, 16-bit or interlaced PNG,
  4:1:1 or 4:4:0 JPEG, CMYK or RGB JPEG, ...) is decoded by PIL on
  the host, as JAX decodes every file, and moved to the device asked for.

A failure of the port's PNG reader or of nvJPEG on a file the header gave
them raises; it is never handed to PIL.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
import zlib
from io import BytesIO
from typing import Tuple

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.ops import cuda_build

__all__ = ["NVJPEG_DECODES", "decode_rgb", "decoder_of", "image_format",
           "image_size", "read_label_array", "read_png_array"]

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"

# colour type (L, RGB, P, LA, RGBA) -> (samples per pixel, allowed depths)
_COLOUR = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
           4: (2, (8,)), 6: (4, (8,))}

_NVJPEG = "nvjpeg_decode"  # csrc/nvjpeg_decode.cu
# decodes that went through nvJPEG (one per decode_rgb call on the card
# for a JPEG)
NVJPEG_DECODES = 0
_count_lock = threading.Lock()


def image_format(data: bytes) -> str:
    """``"png"``, ``"jpeg"`` or ``"unknown"``, from the magic bytes."""
    if data.startswith(PNG_MAGIC):
        return "png"
    if data.startswith(JPEG_MAGIC):
        return "jpeg"
    return "unknown"


def _chunks(data: bytes):
    """(type, payload) of each PNG chunk, up to IEND."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length:
            raise ValueError(f"PNG chunk {kind!r} truncated")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file has no IEND chunk")


def _header(ihdr: bytes) -> Tuple[int, int, int, int]:
    """(width, height, bit depth, colour type), refusing what the reader
    does not take."""
    w, h, depth, colour, compression, filt, interlace = struct.unpack(
        ">IIBBBBB", ihdr)
    if colour not in _COLOUR or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG colour type {colour} at {depth} bits is invalid")
    if depth == 16:
        raise ValueError("16-bit PNG files are not supported by the port's "
                         "PNG reader")
    if depth not in _COLOUR[colour][1]:
        raise ValueError(f"PNG colour type {colour} at {depth} bits is invalid")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported by "
                         "the port's PNG reader")
    if compression or filt:
        raise ValueError(f"PNG compression {compression} / filter method "
                         f"{filt} is invalid")
    return w, h, depth, colour


def _png_reader_takes(data: bytes) -> bool:
    """Whether the port's PNG reader takes this PNG, from its IHDR: every
    file but a 16-bit or an interlaced one (what the IHDR holds otherwise
    is the reader's to check)."""
    if data[12:16] != b"IHDR" or len(data) < 29:
        return True
    depth, interlace = data[24], data[28]
    return depth != 16 and not interlace


def _jpeg_frame(data: bytes):
    """(SOF marker, sample precision, [(h, v) sampling factors of each
    component], Adobe colour transform or None, [component IDs]) from the
    JPEG's markers up to its first SOF segment; None when the header ends
    first."""
    pos, adobe = 2, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:          # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2                # no length
            continue
        if marker in (0xD9, 0xDA):  # end of image / scan before any frame
            return None
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if len(seg) < 6:
                return None
            n = seg[5]
            comps = [(seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15)
                     for i in range(n) if 8 + 3 * i < len(seg)]
            ids = [seg[6 + 3 * i] for i in range(len(comps))]
            return marker, seg[0], comps, adobe, ids
        pos += 2 + length
    return None


# chroma upsampling factors (vertical, horizontal) the card path finishes
_NVJPEG_SUBSAMPLING = ((1, 1), (1, 2), (2, 2))


def _nvjpeg_takes(data: bytes) -> bool:
    """Whether the card's JPEG path takes this JPEG, from its SOF segment:
    baseline, extended or progressive Huffman at 8 bits, grey, or YCbCr
    whose two chroma components share a sampling that is 4:4:4, 4:2:2 or
    4:2:0 of the luma's. libjpeg (so PIL) reads three components as RGB,
    not YCbCr, under an Adobe transform of 0 or, with no Adobe marker,
    under the component IDs 'R', 'G', 'B': those go to PIL."""
    frame = _jpeg_frame(data)
    if frame is None:
        return False
    marker, precision, comps, adobe, ids = frame
    if marker not in (0xC0, 0xC1, 0xC2) or precision != 8:
        return False
    if len(comps) == 1:
        return True
    if len(comps) != 3 or adobe == 0 or comps[1] != comps[2]:
        return False   # adobe 0: RGB, not YCbCr
    if adobe is None and ids == list(b"RGB"):
        return False
    (hy, vy), (hc, vc) = comps[0], comps[1]
    if not hc or not vc or hy % hc or vy % vc:
        return False
    return (vy // vc, hy // hc) in _NVJPEG_SUBSAMPLING


def decoder_of(data: bytes, device=None) -> str:
    """Which decoder takes ``data`` for ``device`` (None: CUDA), from the
    header alone: ``"png"`` (the port's reader), ``"nvjpeg"``, or ``"pil"``
    (on the host, then moved to the device)."""
    kind = image_format(data)
    if kind == "png" and _png_reader_takes(data):
        return "png"
    cuda = device is None or torch.device(device).type == "cuda"
    if kind == "jpeg" and cuda and _nvjpeg_takes(data):
        return "nvjpeg"
    return "pil"


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file: a PNG's from its IHDR chunk alone,
    any other file's from PIL's header read (JAX ``max_label_size``)."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_MAGIC) + 8 + 13)
    if head.startswith(PNG_MAGIC) and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return w, h
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. raw: (H, 1 + row bytes) uint8, each row
    its filter type and its filtered bytes. A pixel depends on the one to
    its left and the two above, so the pixels are taken in wavefronts
    (row + pixel index constant), each at once: in skewed coordinates
    (column = row + pixel index) a wavefront is one column, and its
    neighbours are slices of the two columns before it."""
    ftype = raw[:, 0].astype(np.int64)
    x = raw[:, 1:]
    if not ftype.any():
        return x.copy()
    if ftype.max() > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is invalid")
    h, nbytes = x.shape
    npix = nbytes // bpp
    rows = np.arange(h)
    # skewed input and output: pixel (r, p) at (r, r + p); the output has
    # a zero row above and two zero columns to the left, which are what
    # the filters read above the first row and left of the first pixel
    xs = np.zeros((h, h + npix, bpp), np.int16)
    xs[rows[:, None], rows[:, None] + np.arange(npix)] = x.reshape(h, npix, bpp)
    out = np.zeros((h + 1, h + npix + 2, bpp), np.int16)
    sub, up, avg, paeth = ((ftype == k)[:, None] for k in (1, 2, 3, 4))
    for t in range(h + npix - 1):
        r0, r1 = max(0, t - npix + 1), min(h, t + 1)
        a = out[r0 + 1:r1 + 1, t + 1]          # left
        b = out[r0:r1, t + 1]                  # above
        c = out[r0:r1, t]                      # above left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(paeth[r0:r1], np.where((pa <= pb) & (pa <= pc), a,
                                               np.where(pb <= pc, b, c)), 0)
        pred = np.where(sub[r0:r1], a, pred)
        pred = np.where(up[r0:r1], b, pred)
        pred = np.where(avg[r0:r1], (a + b) >> 1, pred)
        out[r0 + 1:r1 + 1, t + 2] = (xs[r0:r1, t] + pred) & 255
    flat = out[1:, 2:][rows[:, None], rows[:, None] + np.arange(npix)]
    return flat.reshape(h, nbytes).astype(np.uint8)


def _png(data: bytes):
    """(samples (H, W, channels) uint8 at the file's depth, depth, colour
    type, palette (n, 3) uint8 or None)."""
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = _header(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour = header
    channels = _COLOUR[colour][0]
    row_bytes = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError("PNG image data is truncated")
    rows = _unfilter(raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1),
                     max(1, channels * depth // 8))
    if depth < 8:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, row_bytes * per_byte)[:, :w]
    if colour == 3 and palette is None:
        raise ValueError("palette PNG file has no PLTE chunk")
    return rows.reshape(h, w, channels), depth, colour, palette


def read_label_array(data: bytes) -> np.ndarray:
    """A label file's array as ``np.asarray(Image.open(...))`` gives it (JAX
    ``SegDataset``): the port's PNG reader for the PNGs it takes, PIL for
    any other file (16-bit or interlaced PNG, another format)."""
    if image_format(data) == "png" and _png_reader_takes(data):
        return read_png_array(data)
    from PIL import Image

    with Image.open(BytesIO(data)) as im:
        return np.asarray(im)


def read_png_array(data: bytes) -> np.ndarray:
    """A PNG's pixels as ``np.asarray(Image.open(...))`` gives them:
    (H, W) for L, 1-bit grey (bool) and P (palette indices); (H, W, c) for
    RGB, LA and RGBA."""
    samples, depth, colour, _ = _png(data)
    if colour == 0 and depth == 1:
        return samples[..., 0].astype(bool)
    if colour == 0 and depth < 8:
        # PIL's "L;2" / "L;4" unpack scales to 0-255
        return samples[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    return samples[..., 0] if samples.shape[-1] == 1 else samples


def _png_rgb(data: bytes) -> np.ndarray:
    """``Image.open(...).convert("RGB")`` of a PNG as (H, W, 3) uint8."""
    samples, depth, colour, palette = _png(data)
    if colour == 3:
        # indices past the palette's end read black, as PIL's 256-entry
        # palette holds zeros there
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[samples[..., 0]]
    if colour in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def _pil_rgb(data: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError("decoding this file needs PIL (a JPEG on the CPU, "
                           "or a format the port's readers do not take), "
                           "which is not installed") from err
    with Image.open(BytesIO(data)) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)


# libjpeg's YCbCr -> RGB constants (jdcolor.c: FIX(x) at 16 bits)
_SCALEBITS = 16


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def libjpeg_upsample(plane: torch.Tensor, fy: int, fx: int, height: int,
                     width: int) -> torch.Tensor:
    """libjpeg's fancy chroma upsampling (jdsample.c ``h2v2_fancy_upsample``
    and ``h2v1_fancy_upsample``) of an (h, w) uint8 plane by (fy, fx) in
    {(1, 1), (1, 2), (2, 2)}, cropped to (height, width): each output pixel
    3/4 of its nearer sample and 1/4 of the next nearer in each upsampled
    direction, edges clamped, rounded as libjpeg rounds (alternately down
    and up). Planes two samples wide or less are replicated, as libjpeg
    does."""
    if (fy, fx) == (1, 1):
        return plane[:height, :width]
    if (fy, fx) not in ((1, 2), (2, 2)):
        raise NotImplementedError(f"JPEG chroma subsampling {fy}x{fx}: the "
                                  "port upsamples 4:4:4, 4:2:2 and 4:2:0")
    h, w = plane.shape
    c = plane.to(torch.int32)
    if w <= 2:
        out = c.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
        return out[:height, :width].to(torch.uint8)
    prev_col = torch.cat([c[:, :1], c[:, :-1]], 1)
    next_col = torch.cat([c[:, 1:], c[:, -1:]], 1)
    if fy == 1:
        left = (3 * c + prev_col + 1) >> 2
        right = (3 * c + next_col + 2) >> 2
    else:
        up = torch.cat([c[:1], c[:-1]], 0)
        down = torch.cat([c[1:], c[-1:]], 0)
        cols = torch.stack([3 * c + up, 3 * c + down], 1).reshape(2 * h, w)
        prev_col = torch.cat([cols[:, :1], cols[:, :-1]], 1)
        next_col = torch.cat([cols[:, 1:], cols[:, -1:]], 1)
        left = (3 * cols + prev_col + 8) >> 4
        right = (3 * cols + next_col + 7) >> 4
    out = torch.stack([left, right], 2).reshape(left.shape[0], 2 * w)
    return out[:height, :width].to(torch.uint8)


def libjpeg_ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """libjpeg's integer YCbCr -> RGB (jdcolor.c ``ycc_rgb_convert``) of
    three (H, W) uint8 planes: (H, W, 3) uint8."""
    half = 1 << (_SCALEBITS - 1)
    y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + half) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + half) >> _SCALEBITS)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=1)
def _nvjpeg_library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NVJPEG, link=("-lnvjpeg",))
    p, i = ctypes.c_void_p, ctypes.c_int
    size_t = ctypes.c_size_t
    # data, bytes, components, subsampling, widths[4], heights[4] (out)
    lib.nvjpeg_image_info.argtypes = [ctypes.c_char_p, size_t, p, p, p, p]
    lib.nvjpeg_image_info.restype = i
    # data, bytes, plane pointers, plane pitches, components, stream
    lib.nvjpeg_decode_planes.argtypes = [ctypes.c_char_p, size_t, p, p, i, p]
    lib.nvjpeg_decode_planes.restype = i
    return lib


def _nvjpeg_rgb(data: bytes, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 on ``device``: nvJPEG decodes the component planes
    on the current stream, then ``libjpeg_upsample`` and
    ``libjpeg_ycc_to_rgb`` finish on the card as PIL's libjpeg does (grey
    JPEGs come out replicated, as PIL's convert gives them)."""
    lib = _nvjpeg_library()
    comps, css = ctypes.c_int(), ctypes.c_int()
    widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    status = lib.nvjpeg_image_info(data, len(data), ctypes.byref(comps),
                                   ctypes.byref(css), widths, heights)
    cuda_build.check_status(lib, _NVJPEG, "nvjpeg_image_info", status)
    n = comps.value
    if n not in (1, 3):
        raise ValueError(f"a JPEG of {n} components: the port decodes grey "
                         "and YCbCr JPEGs only")
    planes = [torch.empty((heights[c], widths[c]), dtype=torch.uint8,
                          device=device) for c in range(n)]
    ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in planes))
    pitches = (ctypes.c_int * n)(*(t.shape[1] for t in planes))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nvjpeg_decode_planes(data, len(data), ptrs, pitches, n,
                                          stream)
    cuda_build.check_status(lib, _NVJPEG, "nvjpeg_decode_planes", status)
    global NVJPEG_DECODES
    with _count_lock:
        NVJPEG_DECODES += 1
    h, w = planes[0].shape
    if n == 1:
        return planes[0][:, :, None].expand(h, w, 3).contiguous()
    chroma = []
    for t in planes[1:]:
        fy, fx = -(-h // t.shape[0]), -(-w // t.shape[1])
        # libjpeg upsamples the component's own samples, ceil(size /
        # factor) of them, and clamps at their edge
        chroma.append(libjpeg_upsample(t[:-(-h // fy), :-(-w // fx)], fy, fx,
                                       h, w))
    return libjpeg_ycc_to_rgb(planes[0], *chroma)


def decode_rgb(data: bytes, device=None) -> torch.Tensor:
    """An encoded image as (H, W, 3) uint8 RGB on ``device`` (None: CUDA),
    equal to PIL's ``Image.open(...).convert("RGB")``, through the decoder
    ``decoder_of`` gives it (for a JPEG on the card nvJPEG's IDCT)."""
    device = resolve_device(device)
    route = decoder_of(data, device)
    if route == "png":
        return torch.from_numpy(_png_rgb(data)).to(device)
    if route == "nvjpeg":
        return _nvjpeg_rgb(data, device)
    return torch.from_numpy(_pil_rgb(data)).to(device)
