"""The native decode library (port of ``simseg_tpu/data/native.py``, over
the port's own copy of its C++ source, ``data/_native/decode.cc``).

JPEG through libjpeg, with the crop folded in and, when asked
(``fast_scale``), DCT-domain scaling by 1/2, 1/4 or 1/8 where the target
allows it; PNG through libpng, WebP through libwebp; crop, PIL-style
antialiased resample (within 1 of PIL's, not equal) and horizontal flip in
C++. Loader threads call it without the interpreter lock, and
``BatchDecoder`` decodes a whole batch on a C++ thread pool.

The library builds with ``g++`` at first use into ``simseg_tpu_torch/_build/``
(gitignored), named by the source's hash; nothing is prebuilt. When it
cannot build (no compiler, no codec headers) or ``SIMSEG_NATIVE=0`` is
set, ``available()`` is False and callers take the port's own reader, as
the JAX package falls back to PIL; ``build_error()`` says why. This is host
code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "data", "_native", "decode.cc")
BUILD_DIR = os.path.join(_PKG, "_build")

FILTER_BILINEAR = 0
FILTER_BICUBIC = 1
FILTER_NEAREST = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> str:
    """Where the build of the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libsimseg_decode-{digest}.so")


def _build() -> Optional[str]:
    """The built library's path, or None (the reason in ``_error``)."""
    global _error
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a private name renamed into place: a concurrent process never loads a
    # half-written library
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", SOURCE, "-o", tmp,
           "-ljpeg", "-lpng", "-lwebp", "-pthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as err:
        _error = f"g++: {err}"
        return None
    if proc.returncode != 0:
        lines = [ln for ln in proc.stderr.splitlines() if "error" in ln]
        _error = (lines or proc.stderr.splitlines() or ["g++ failed"])[0]
        return None
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried, _error = True, None
        if os.environ.get("SIMSEG_NATIVE", "1") == "0":
            _error = "SIMSEG_NATIVE=0"
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as err:
            _error = str(err)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ci, cp = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.ssd_image_size.argtypes = [u8p, ctypes.c_size_t, cp, cp]
        lib.ssd_image_size.restype = ci
        lib.ssd_decode.argtypes = [u8p, ctypes.c_size_t,
                                   ci, ci, ci, ci,       # crop x, y, w, h
                                   ci, ci,               # out w, h
                                   ci, ci, ci,           # flip, filter, fast
                                   u8p]
        lib.ssd_decode.restype = ci
        lib.ssd_pool_new.argtypes = [ci]
        lib.ssd_pool_new.restype = ctypes.c_void_p
        lib.ssd_pool_free.argtypes = [ctypes.c_void_p]
        lib.ssd_pool_decode_batch.argtypes = [
            ctypes.c_void_p, ci, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t), cp, ci, ci, cp, ci, ci, u8p, cp]
        lib.ssd_pool_decode_batch.restype = ci
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why ``available()`` is False: the compiler's first error line, the
    loader's message or ``SIMSEG_NATIVE=0``; None when it is True."""
    _load()
    return _error


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native decode library is unavailable: {_error}")
    return lib


def image_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the encoded header; ValueError on an unknown
    or corrupt header."""
    lib = _lib_or_raise()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ssd_image_size(_as_u8p(data), len(data), ctypes.byref(w),
                            ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"cannot read image header (rc={rc})")
    return w.value, h.value


def decode(data: bytes, crop: Optional[Tuple[int, int, int, int]] = None,
           out_size: Optional[Tuple[int, int]] = None, flip: bool = False,
           filter: int = FILTER_BILINEAR, fast_scale: bool = True) -> np.ndarray:
    """Decode, crop (x, y, w, h), resample to ``out_size`` (w, h) and flip:
    an (H, W, 3) uint8 array. The call runs without the interpreter lock."""
    lib = _lib_or_raise()
    cx, cy, cw, ch = crop if crop is not None else (-1, -1, -1, -1)
    if out_size is None:
        w, h = image_size(data)
        if crop is not None:
            # the C side clamps the box to the image and, with no out_size,
            # emits the clamped size: size the buffer the same way
            cx2, cy2 = min(max(cx, 0), w), min(max(cy, 0), h)
            ow, oh = min(cw, w - cx2), min(ch, h - cy2)
            if ow <= 0 or oh <= 0:
                raise ValueError(f"crop {crop} outside image {w}x{h}")
        else:
            ow, oh = w, h
    else:
        ow, oh = out_size
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.ssd_decode(
        _as_u8p(data), len(data), cx, cy, cw, ch,
        ow if out_size is not None else 0, oh if out_size is not None else 0,
        int(flip), int(filter), int(fast_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"native decode failed (rc={rc})")
    return out


class BatchDecoder:
    """A persistent C++ thread pool that decodes a whole batch in one call
    into a contiguous (N, H, W, 3) uint8 array."""

    def __init__(self, threads: int = 0):
        self._lib = _lib_or_raise()
        self._pool = self._lib.ssd_pool_new(threads or (os.cpu_count() or 4))

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool:
            self._lib.ssd_pool_free(pool)
            self._pool = None

    def decode_batch(self, datas: Sequence[bytes], out_w: int, out_h: int,
                     crops: Optional[Sequence[Tuple[int, int, int, int]]] = None,
                     flips: Optional[Sequence[bool]] = None,
                     filter: int = FILTER_BILINEAR,
                     fast_scale: bool = True) -> np.ndarray:
        n = len(datas)
        bufs = (ctypes.c_void_p * n)(
            *[ctypes.cast(ctypes.c_char_p(d), ctypes.c_void_p) for d in datas])
        lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
        flat_crops = (ctypes.c_int * (4 * n))()
        for i in range(n):
            flat_crops[4 * i:4 * i + 4] = (crops[i] if crops is not None
                                           else (-1, -1, -1, -1))
        flat_flips = (ctypes.c_int * n)(
            *[int(flips[i]) if flips is not None else 0 for i in range(n)])
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        status = (ctypes.c_int * n)()
        rc = self._lib.ssd_pool_decode_batch(
            self._pool, n, bufs, lens, flat_crops, out_w, out_h, flat_flips,
            int(filter), int(fast_scale),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), status)
        if rc != 0:
            bad = [i for i in range(n) if status[i] != 0]
            raise ValueError(f"native batch decode failed for indices {bad}")
        return out
