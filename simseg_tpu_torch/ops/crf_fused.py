"""Mean-field dense CRF + binary closing as one hand-written CUDA kernel
(port of ``simseg_tpu/ops/crf_fused.py:mean_field_fused``).

``mean_field_fused`` takes the unary difference ``du`` and the images and
returns the refined (optionally closed) 0/1 masks, as the TPU kernel does.
On a CPU tensor it runs ``mean_field_fused_plain`` (the plain CRF of
``ops/crf.py`` composed with ``ops/morphology.closing``); on a CUDA tensor it
launches ``csrc/crf_mean_field.cu`` or raises — there is no fallback.

The kernel is built at first use by ``ops/cuda_build.py`` and loaded with
``ctypes``. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from simseg_tpu_torch.ops import cuda_build
from simseg_tpu_torch.ops.crf import (
    band_matrix,
    bilateral_features,
    cell_colours,
    dense_crf_batched_du,
    gaussian_taps,
)
from simseg_tpu_torch.ops.morphology import closing

__all__ = ["LAUNCHES", "bilateral_features", "fused_eligible",
           "gaussian_constants", "mean_field_fused", "mean_field_fused_plain"]

_NAME = "crf_mean_field"  # csrc/crf_mean_field.cu
_F_PAD = 8            # padded feature width (2 pos + 3 rgb)
_MAX_CLASSES = 8      # kMaxClasses in the kernel
_MAX_RADIUS = 16      # kMaxRadius in the kernel

# launches of the CUDA kernel (one per mean_field_fused call on the card)
LAUNCHES = 0


def fused_eligible(h: int, w: int, stride: int) -> bool:
    """The grids the decode sends to the fused kernel: the TPU kernel's
    VMEM limits (``simseg_tpu/ops/crf_fused.py:fused_eligible``, :126-132),
    kept so that the port routes each shape as the JAX package does."""
    if h % stride or w % stride:
        return False
    n = (h // stride) * (w // stride)
    return n <= 1600 and h * w <= 512 * 512


def gaussian_constants(h: int, w: int, gaussian_sxy: float):
    """(taps, ah, aw) in float64: the Gaussian taps and the row/column
    normalisations ``1 / sqrt(band.sum(0) + 1e-20)`` of the truncated band
    matrices (``simseg_tpu/ops/crf_fused.py:_np_constants``, :61-77)."""
    taps = gaussian_taps(gaussian_sxy)
    ah = 1.0 / np.sqrt(band_matrix(h, taps).sum(axis=0) + 1e-20)
    aw = 1.0 / np.sqrt(band_matrix(w, taps).sum(axis=0) + 1e-20)
    return taps, ah, aw


@functools.lru_cache(maxsize=32)
def _device_constants(h: int, w: int, gaussian_sxy: float, device: torch.device):
    """``gaussian_constants`` as float32 tensors on ``device``, kept so that
    a call makes no host-to-device copy."""
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in gaussian_constants(h, w, gaussian_sxy))


def mean_field_fused_plain(du, rgb, num_iters=3, gaussian_sxy=3.0,
                           gaussian_compat=3.0, bilateral_sxy=40.0,
                           bilateral_srgb=13.0, bilateral_compat=10.0,
                           stride=8, closing_ksize=0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CRF's materialised-K
    lane, on any device): (B, K, H, W) float32 masks."""
    masks = dense_crf_batched_du(
        du, rgb, num_iters=num_iters, gaussian_sxy=gaussian_sxy,
        gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
        bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
        bilateral_stride=stride, bilateral_impl="dense").float()
    if closing_ksize > 1:
        masks = closing(masks, closing_ksize)
    return masks


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NAME)
    fn = lib.crf_mean_field_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p,            # du, feat, taps, ah, aw
                   i, i, i, i, i, i, i,      # B, K, H, W, stride, radius, iters
                   f, f, i,                  # compat g, compat b, closing k
                   p, p, p, p, p, p, p,      # d_work, q, m, bn, masks, out
                   p]                        # stream
    fn.restype = ctypes.c_int
    return lib


def mean_field_fused(du: torch.Tensor, rgb: torch.Tensor, num_iters: int = 3,
                     gaussian_sxy: float = 3.0, gaussian_compat: float = 3.0,
                     bilateral_sxy: float = 40.0, bilateral_srgb: float = 13.0,
                     bilateral_compat: float = 10.0, stride: int = 8,
                     closing_ksize: int = 0) -> torch.Tensor:
    """Mean-field refinement (+ closing when ``closing_ksize > 1``).

    du:  (B, K, H, W) float32, contiguous: ``log(p + 1e-8) - log(1 - p + 1e-8)``.
    rgb: (B, H, W, 3) images on du's device, 0..255 scale, any dtype.
    Returns (B, K, H, W) float32 0/1 masks.
    """
    if du.dim() != 4 or du.dtype != torch.float32 or not du.is_contiguous():
        raise ValueError("du must be a contiguous (B, K, H, W) float32 tensor, "
                         f"got {tuple(du.shape)} {du.dtype}")
    b, kk, h, w = du.shape
    if tuple(rgb.shape) != (b, h, w, 3):
        raise ValueError(f"rgb must be {(b, h, w, 3)}, got {tuple(rgb.shape)}")
    if rgb.device != du.device:
        raise ValueError(f"du on {du.device} but rgb on {rgb.device}")
    if h % stride or w % stride:
        raise ValueError(f"map {h}x{w} not divisible by stride {stride}")
    if du.device.type == "cpu":
        return mean_field_fused_plain(
            du, rgb, num_iters=num_iters, gaussian_sxy=gaussian_sxy,
            gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
            bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
            stride=stride, closing_ksize=closing_ksize)
    if du.device.type != "cuda":
        raise ValueError(f"no CRF path for device {du.device}")
    if kk > _MAX_CLASSES:
        raise ValueError(f"{kk} maps per image; the kernel takes <= {_MAX_CLASSES}")
    lib = _library()
    dev = du.device
    taps, ah, aw = _device_constants(h, w, float(gaussian_sxy), dev)
    radius = taps.shape[0] // 2
    if radius > _MAX_RADIUS:
        raise ValueError(f"Gaussian radius {radius} > {_MAX_RADIUS}")

    feat = bilateral_features(cell_colours(rgb, stride), bilateral_sxy,
                              bilateral_srgb, stride)
    feat = F.pad(feat, (0, _F_PAD - feat.shape[-1])).contiguous()
    n = (h // stride) * (w // stride)
    d_work = torch.empty_like(du)
    q = torch.empty((b, kk, n), dtype=torch.float32, device=dev)
    m = torch.empty_like(q)
    bn = torch.empty((b, n), dtype=torch.float32, device=dev)
    masks = [torch.empty(du.shape, dtype=torch.uint8, device=dev)
             for _ in range(2 if closing_ksize > 1 else 0)]
    out = torch.empty_like(du)
    mask_ptrs = [t.data_ptr() for t in masks] or [None, None]
    status = lib.crf_mean_field_f32(
        du.data_ptr(), feat.data_ptr(), taps.data_ptr(), ah.data_ptr(),
        aw.data_ptr(), b, kk, h, w, stride, radius, num_iters,
        float(gaussian_compat), float(bilateral_compat), int(closing_ksize),
        d_work.data_ptr(), q.data_ptr(), m.data_ptr(), bn.data_ptr(),
        *mask_ptrs, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_status(lib, _NAME, "crf_mean_field_f32", status)
    global LAUNCHES
    LAUNCHES += 1
    return out
