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

On the card each call takes the images as they are (uint8 or float32; any
other dtype is cast first), one workspace from ``torch.empty`` and no other
device work: the features, the mean field, the closing and (tail) the argmax
all run inside the kernel. ``launch_plan`` is how the kernel cuts a call
(update tile, shared memory per block); ``csrc/crf_mean_field.cu`` checks it.

The kernels are built at first use by ``ops/cuda_build.py`` and loaded with
``ctypes``. ``LAUNCHES`` counts the mean-field kernel's launches,
``TAIL_LAUNCHES`` the tail kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from simseg_tpu_torch.ops import cuda_build
from simseg_tpu_torch.ops.crf import (
    band_matrix,
    bilateral_features,
    dense_crf_batched_du,
    gaussian_taps,
)
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample

__all__ = ["LAUNCHES", "SMEM_LIMIT", "TAIL_LAUNCHES", "LaunchPlan",
           "bilateral_features", "fused_eligible", "gaussian_constants",
           "launch_plan", "mean_field_fused", "mean_field_fused_plain",
           "seg_decode_tail_fused", "seg_decode_tail_fused_plain",
           "workspace_floats"]

_NAME = "crf_mean_field"  # csrc/crf_mean_field.cu
_MAX_CLASSES = 8      # kMaxClasses in the kernel
_MAX_RADIUS = 16      # kMaxRadius in the kernel
# the kernel's cuts (csrc/crf_mean_field.cu): largest update tile, Gaussian
# outputs per thread, message cells per staged tile, closing rows per
# block; the shared memory a block may take on sm_90
_TILE_H, _TILE_W, _STRIP = 32, 64, 8
_CHUNK, _BAND = 512, 32
SMEM_LIMIT = 232448

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
    fn.argtypes = [p, p, i, p, p, p,        # du, rgb, rgb is uint8, taps, ah, aw
                   i, i, i, i, i, i, i,      # B, K, H, W, stride, radius, iters
                   f, f, f, f, i,            # compat g, compat b, sxy, srgb,
                                             # closing k
                   i, i, i,                  # tile h, tile w, shared bytes
                   p, p, p, p]               # work, barrier, out, stream
    fn.restype = ctypes.c_int
    fn = lib.crf_decode_tail_f32
    fn.argtypes = [p, p, i, p, p, p,        # du_coarse, rgb, uint8, taps, ah, aw
                   p, p, i,                  # scores, cand_idx, cand_idx is int64
                   i, i, i, i, i, i, i, i,   # B, K, H, W, factor, stride,
                                             # radius, iters
                   f, f, f, f, i,            # compat g, compat b, sxy, srgb,
                                             # closing k
                   i, i, i,                  # tile h, tile w, shared bytes
                   p, p, p, p, p]            # work, barrier, pred, best_w,
                                             # stream
    fn.restype = ctypes.c_int
    return lib


class LaunchPlan(NamedTuple):
    """How the kernel cuts a call (the C side checks it): the update tile,
    whether its cells are whole (the splat fused into the update), and the
    shared memory per block."""
    tile_h: int
    tile_w: int
    fused_splat: bool
    smem_bytes: int


def launch_plan(h: int, w: int, stride: int, radius: int, num_classes: int,
                num_iters: int, closing_ksize: int, tail: bool = False) -> LaunchPlan:
    """The kernel's plan for a call, mirroring ``smem_need`` and
    ``tile_layout`` of ``csrc/crf_mean_field.cu``: update tiles of whole
    stride cells up to 32 x 64 (past that, 32 or 64 and a separate splat),
    and the largest of an update tile with its radius-r halo, a message
    tile (features and K values of 512 cells), a closing band and a cell
    row's column sums."""
    tile_h = stride * (_TILE_H // stride) if stride <= _TILE_H else _TILE_H
    tile_w = stride * (_TILE_W // stride) if stride <= _TILE_W else _TILE_W
    thp, twp = -(-tile_h // _STRIP) * _STRIP, -(-tile_w // _STRIP) * _STRIP
    span = 2 * radius
    need = ((thp + span) * (((twp + span) | 1) + twp + 1)
            + 2 * (thp + span) + 2 * (twp + span) + thp
            + 2 * _MAX_RADIUS + 1 + thp * twp)
    if num_iters > 0:
        need = max(need, _CHUNK * (5 + num_classes), 3 * w)
    words = -(-w // 32)
    k = max(closing_ksize, 1)
    need = max(need, 2 * min(h, _BAND + 2 * (k - 1)) * words
               + (num_classes if tail else 1) * _BAND * words)
    return LaunchPlan(tile_h, tile_w,
                      tile_h % stride == 0 and tile_w % stride == 0, 4 * need)


def workspace_floats(b: int, k: int, h: int, w: int, stride: int) -> int:
    """Floats of the kernel's workspace: features (B, N, 8), bn (B, N), q
    and m (B, K, N), two iterates (B, K, H, W), the last one's mask bits
    (B, K, H, ceil(W / 32)) words."""
    n = (h // stride) * (w // stride)
    return b * n * 9 + 2 * b * k * n + 2 * b * k * h * w + b * k * h * (-(-w // 32))


@functools.lru_cache(maxsize=None)
def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's grid barrier, two words per (device, stream), zeroed
    once: the arrival count is back to 0 after every barrier, the release
    count is only compared. Calls on one stream run in order, so they may
    share them."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def _launch_inputs(du, rgb, h, w, stride, gaussian_sxy, num_iters,
                   closing_ksize, tail):
    """(taps, ah, aw, radius, rgb as the kernel reads it, plan, workspace,
    barrier, stream) of a call on du's card."""
    dev = du.device
    taps, ah, aw = _device_constants(h, w, float(gaussian_sxy), dev)
    radius = taps.shape[0] // 2
    if radius > _MAX_RADIUS:
        raise ValueError(f"Gaussian radius {radius} > {_MAX_RADIUS}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        rgb = rgb.float()
    rgb = rgb.contiguous()
    b, kk = du.shape[:2]
    plan = launch_plan(h, w, stride, radius, kk, num_iters, closing_ksize, tail)
    work = torch.empty(workspace_floats(b, kk, h, w, stride),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (taps, ah, aw, radius, rgb, plan, work, _barrier(dev, stream),
            stream)


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
    taps, ah, aw, radius, rgb, plan, work, barrier, stream = _launch_inputs(
        du, rgb, h, w, stride, gaussian_sxy, num_iters, closing_ksize, False)
    out = torch.empty_like(du)
    with torch.cuda.device(du.device):
        status = lib.crf_mean_field_f32(
            du.data_ptr(), rgb.data_ptr(), int(rgb.dtype == torch.uint8),
            taps.data_ptr(), ah.data_ptr(), aw.data_ptr(), b, kk, h, w, stride,
            radius, num_iters, float(gaussian_compat), float(bilateral_compat),
            float(bilateral_sxy), float(bilateral_srgb), int(closing_ksize),
            plan.tile_h, plan.tile_w, plan.smem_bytes, work.data_ptr(),
            barrier.data_ptr(), out.data_ptr(), stream)
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
    du_coarse = du_coarse.float().contiguous()
    scores_eff = scores_eff.float().contiguous()
    if cand_idx.dtype not in (torch.int32, torch.int64):
        cand_idx = cand_idx.to(torch.int32)
    cand_idx = cand_idx.contiguous()
    taps, ah, aw, radius, rgb, plan, work, barrier, stream = _launch_inputs(
        du_coarse, rgb, h, w, stride, gaussian_sxy, num_iters, closing_ksize,
        True)
    pred = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    best_w = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.crf_decode_tail_f32(
            du_coarse.data_ptr(), rgb.data_ptr(), int(rgb.dtype == torch.uint8),
            taps.data_ptr(), ah.data_ptr(), aw.data_ptr(), scores_eff.data_ptr(),
            cand_idx.data_ptr(), int(cand_idx.dtype == torch.int64), b, kk, h, w,
            du_factor, stride, radius, num_iters, float(gaussian_compat),
            float(bilateral_compat), float(bilateral_sxy),
            float(bilateral_srgb), int(closing_ksize), plan.tile_h,
            plan.tile_w, plan.smem_bytes, work.data_ptr(), barrier.data_ptr(),
            pred.data_ptr(), best_w.data_ptr(), stream)
    cuda_build.check_status(lib, _NAME, "crf_decode_tail_f32", status)
    global TAIL_LAUNCHES
    TAIL_LAUNCHES += 1
    return pred, best_w
