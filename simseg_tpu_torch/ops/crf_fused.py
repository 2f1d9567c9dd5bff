"""Mean-field dense CRF + binary closing, and the whole decode tail, as
hand-written CUDA kernels (port of ``simseg_tpu/ops/crf_fused.py``:
``mean_field_fused`` and ``seg_decode_tail_fused``).

``mean_field_fused`` takes the unary difference ``du`` and the images and
returns the refined (optionally closed) 0/1 masks, as the TPU kernel does.
On a CPU tensor it runs ``mean_field_fused_plain`` (the plain CRF of
``ops/crf.py`` composed with ``ops/morphology.closing``); on a CUDA tensor it
launches ``csrc/crf_mean_field.cu`` or raises — there is no fallback.

``seg_decode_tail_fused`` adds the decode's tail: it takes the patch-grid
unaries and returns the score-weighted argmax (pred, best weight), with the
nearest upsample and the argmax inside the kernel (the second entry point of
the same source). On a CPU tensor it runs ``seg_decode_tail_fused_plain``.

The kernels are built at first use by ``ops/cuda_build.py`` and loaded with
``ctypes``. ``LAUNCHES`` counts the mean-field kernel's launches,
``TAIL_LAUNCHES`` the tail kernel's.
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
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample

__all__ = ["LAUNCHES", "TAIL_LAUNCHES", "bilateral_features", "fused_eligible",
           "gaussian_constants", "mean_field_fused", "mean_field_fused_plain",
           "seg_decode_tail_fused", "seg_decode_tail_fused_plain"]

_NAME = "crf_mean_field"  # csrc/crf_mean_field.cu
_F_PAD = 8            # padded feature width (2 pos + 3 rgb)
_MAX_CLASSES = 8      # kMaxClasses in the kernel
_MAX_RADIUS = 16      # kMaxRadius in the kernel

# launches of the CUDA kernels (one per mean_field_fused, respectively
# seg_decode_tail_fused, call on the card)
LAUNCHES = 0
TAIL_LAUNCHES = 0


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


def seg_decode_tail_fused_plain(du_coarse, rgb, scores_eff, cand_idx,
                                du_factor, num_iters=3, gaussian_sxy=3.0,
                                gaussian_compat=3.0, bilateral_sxy=40.0,
                                bilateral_srgb=13.0, bilateral_compat=10.0,
                                stride=8, closing_ksize=7):
    """The tail kernel's function in plain PyTorch: ``nearest_upsample`` of
    the patch-grid unaries by ``du_factor``, ``mean_field_fused_plain`` (the
    materialised-K lane) with the closing, then masks * scores_eff and the
    strict-'>' argmax of ``ops/seg_decode.decode_tail``. Returns (pred
    (B, H, W) int32, best_w (B, H, W) f32)."""
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    masks = mean_field_fused_plain(
        nearest_upsample(du_coarse.float(), du_factor), rgb,
        num_iters=num_iters, gaussian_sxy=gaussian_sxy,
        gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
        bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
        stride=stride, closing_ksize=closing_ksize)
    scores_eff = scores_eff.float()
    return decode_tail(masks, cand_idx, scores_eff,
                       torch.ones(scores_eff.shape, dtype=torch.bool,
                                  device=scores_eff.device))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NAME)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.crf_mean_field_f32
    fn.argtypes = [p, p, p, p, p,            # du, feat, taps, ah, aw
                   i, i, i, i, i, i, i,      # B, K, H, W, stride, radius, iters
                   f, f, i,                  # compat g, compat b, closing k
                   p, p, p, p, p, p, p,      # d_work, q, m, bn, masks, out
                   p]                        # stream
    fn.restype = ctypes.c_int
    fn = lib.crf_decode_tail_f32
    fn.argtypes = [p, p, p, p, p, p, p,      # du_coarse, feat, taps, ah, aw,
                                             # scores, cand_idx
                   i, i, i, i, i, i, i, i,   # B, K, H, W, factor, stride,
                                             # radius, iters
                   f, f, i,                  # compat g, compat b, closing k
                   p, p, p, p, p, p, p,      # d_a, d_b, q, m, bn, masks
                   p, p, p]                  # pred, best_w, stream
    fn.restype = ctypes.c_int
    return lib


def _kernel_inputs(rgb, h, w, stride, gaussian_sxy, bilateral_sxy,
                   bilateral_srgb, dev):
    """(taps, ah, aw, radius, feat (B, N, 8)) as the kernels read them."""
    taps, ah, aw = _device_constants(h, w, float(gaussian_sxy), dev)
    radius = taps.shape[0] // 2
    if radius > _MAX_RADIUS:
        raise ValueError(f"Gaussian radius {radius} > {_MAX_RADIUS}")
    feat = bilateral_features(cell_colours(rgb, stride), bilateral_sxy,
                              bilateral_srgb, stride)
    feat = F.pad(feat, (0, _F_PAD - feat.shape[-1])).contiguous()
    return taps, ah, aw, radius, feat


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
    taps, ah, aw, radius, feat = _kernel_inputs(
        rgb, h, w, stride, gaussian_sxy, bilateral_sxy, bilateral_srgb, dev)
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


def seg_decode_tail_fused(du_coarse: torch.Tensor, rgb: torch.Tensor,
                          scores_eff: torch.Tensor, cand_idx: torch.Tensor,
                          du_factor: int, num_iters: int = 3,
                          gaussian_sxy: float = 3.0,
                          gaussian_compat: float = 3.0,
                          bilateral_sxy: float = 40.0,
                          bilateral_srgb: float = 13.0,
                          bilateral_compat: float = 10.0, stride: int = 8,
                          closing_ksize: int = 7):
    """Mean-field CRF + closing + score-weighted argmax in one kernel.

    du_coarse:  (B, K, H/f, W/f) f32 patch-grid unary difference (f =
                ``du_factor``), nearest-upsampled inside the kernel.
    rgb:        (B, H, W, 3) images on du_coarse's device, 0..255 scale.
    scores_eff: (B, K) f32 candidate scores, 0 where the candidate is
                invalid (``where(valid, cand_scores, 0)``).
    cand_idx:   (B, K) class ids.
    Returns (pred (B, H, W) int32, 0 where no weight is positive, and
    best_w (B, H, W) f32), the unfused chain's results.
    """
    if du_coarse.dim() != 4:
        raise ValueError("du_coarse must be (B, K, H/f, W/f), got "
                         f"{tuple(du_coarse.shape)}")
    b, kk, gh, gw = du_coarse.shape
    h, w = gh * du_factor, gw * du_factor
    if tuple(rgb.shape) != (b, h, w, 3):
        raise ValueError(f"rgb must be {(b, h, w, 3)}, got {tuple(rgb.shape)}")
    if tuple(scores_eff.shape) != (b, kk) or tuple(cand_idx.shape) != (b, kk):
        raise ValueError(f"scores_eff and cand_idx must be {(b, kk)}, got "
                         f"{tuple(scores_eff.shape)} and {tuple(cand_idx.shape)}")
    dev = du_coarse.device
    if any(x.device != dev for x in (rgb, scores_eff, cand_idx)):
        raise ValueError(f"rgb, scores_eff and cand_idx must be on {dev}")
    if h % stride or w % stride:
        raise ValueError(f"map {h}x{w} not divisible by stride {stride}")
    kw = dict(num_iters=num_iters, gaussian_sxy=gaussian_sxy,
              gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
              bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
              stride=stride, closing_ksize=closing_ksize)
    if dev.type == "cpu":
        return seg_decode_tail_fused_plain(du_coarse, rgb, scores_eff,
                                           cand_idx, du_factor, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no decode tail for device {dev}")
    if kk > _MAX_CLASSES:
        raise ValueError(f"{kk} maps per image; the kernel takes <= {_MAX_CLASSES}")
    lib = _library()
    taps, ah, aw, radius, feat = _kernel_inputs(
        rgb, h, w, stride, gaussian_sxy, bilateral_sxy, bilateral_srgb, dev)
    du_coarse = du_coarse.float().contiguous()
    scores_eff = scores_eff.float().contiguous()
    cand_idx = cand_idx.to(torch.int32).contiguous()
    n = (h // stride) * (w // stride)
    d_a, d_b = (torch.empty((b, kk, h, w), dtype=torch.float32, device=dev)
                for _ in range(2))
    q = torch.empty((b, kk, n), dtype=torch.float32, device=dev)
    m = torch.empty_like(q)
    bn = torch.empty((b, n), dtype=torch.float32, device=dev)
    mask_a, mask_b = (torch.empty((b, kk, h, w), dtype=torch.uint8, device=dev)
                      for _ in range(2))
    pred = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    best_w = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    status = lib.crf_decode_tail_f32(
        du_coarse.data_ptr(), feat.data_ptr(), taps.data_ptr(), ah.data_ptr(),
        aw.data_ptr(), scores_eff.data_ptr(), cand_idx.data_ptr(), b, kk, h, w,
        du_factor, stride, radius, num_iters, float(gaussian_compat),
        float(bilateral_compat), int(closing_ksize), d_a.data_ptr(),
        d_b.data_ptr(), q.data_ptr(), m.data_ptr(), bn.data_ptr(),
        mask_a.data_ptr(), mask_b.data_ptr(), pred.data_ptr(),
        best_w.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_status(lib, _NAME, "crf_decode_tail_f32", status)
    global TAIL_LAUNCHES
    TAIL_LAUNCHES += 1
    return pred, best_w
