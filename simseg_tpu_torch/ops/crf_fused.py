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
all run inside the kernel, one cooperative launch a call. ``launch_plan``
(``launch_plan_bf16``) is how the kernel cuts a call (update tile, shared
memory per block); ``csrc/crf_mean_field.cu`` (``crf_mean_field_bf16.cu``)
checks it.

Each entry point is a registered custom op, ``simseg::crf_mean_field`` and
``simseg::crf_decode_tail``, with a fake implementation, so that
``torch.export`` (and ``torch.compile``) stage it as one node: its CUDA
implementation launches the kernel, its CPU implementation runs the plain
version. The kernels are built at first use by ``ops/cuda_build.py`` and
loaded with ``ctypes``. ``LAUNCHES`` counts the mean-field kernel's
launches, ``TAIL_LAUNCHES`` the tail kernel's, both counted inside the CUDA
implementations, so that a graph loaded from an exported artifact counts its
launches as it runs.

Both entry points take ``compute_dtype``, as the TPU kernels do: ``"float32"``
(the port's default) or ``"bfloat16"`` (the TPU kernels' default,
``simseg_tpu/ops/crf_fused.py:315, :439``). In bf16 the function rounds to
bf16 where the TPU kernel does (the kernel matrix's entries, the iterate,
every product with a constant matrix summed in float32 and then rounded, the
update's products and sums; ``_mean_field_bf16_plain`` writes it out as
JAX's ``_mf_class`` does), ``mean_field_fused`` returns bf16 masks, and the
card runs ``crf_mean_field_bf16`` / ``crf_decode_tail_bf16`` of
``csrc/crf_mean_field_bf16.cu``, counted in ``BF16_LAUNCHES`` /
``BF16_TAIL_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import types
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch
from simseg_tpu_torch.ops import cuda_build
from simseg_tpu_torch.ops.crf import (
    band_matrix,
    bilateral_features,
    bilateral_kernel_matrix,
    cell_colours,
    dense_crf_batched_du,
    gaussian_taps,
)
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample

__all__ = ["BF16_LAUNCHES", "BF16_TAIL_LAUNCHES", "COMPUTE_DTYPES",
           "LAUNCHES", "SMEM_LIMIT", "TAIL_LAUNCHES", "LaunchPlan",
           "bf16_tables", "bilateral_features", "crf_decode_tail",
           "crf_mean_field", "fused_eligible", "gaussian_constants",
           "kernel_tables", "launch_plan", "launch_plan_bf16", "mean_field_fused",
           "mean_field_fused_plain",
           "seg_decode_tail_fused", "seg_decode_tail_fused_plain",
           "workspace_bytes_bf16", "workspace_floats"]

_NAME = "crf_mean_field"  # csrc/crf_mean_field.cu
_BF16_NAME = "crf_mean_field_bf16"  # csrc/crf_mean_field_bf16.cu
_MAX_CLASSES = 8      # kMaxClasses in the kernel
_MAX_RADIUS = 16      # kMaxRadius in the kernel
# the kernels' cuts (csrc/crf_common.cuh, crf_mean_field.cu): largest
# update tile, Gaussian outputs per thread, message cells per staged tile
# (float32), closing rows per block, warps per block; the shared memory a
# block may take on sm_90
_TILE_H, _TILE_W, _STRIP = 32, 64, 8
_CHUNK, _BAND, _WARPS = 512, 32, 8
SMEM_LIMIT = 232448

# launches of the CUDA kernels (one per mean_field_fused, respectively
# seg_decode_tail_fused, call on the card), float32 and bf16
LAUNCHES = 0
TAIL_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_TAIL_LAUNCHES = 0
COMPUTE_DTYPES = ("float32", "bfloat16")


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


def band_constants(h: int, w: int, gaussian_sxy: float):
    """(bandh (H, H), bandw (W, W)) float64: the truncated Gaussian band
    matrices with their normalisations folded in on both sides,
    ``diag(a) B diag(a)`` (``simseg_tpu/ops/crf_fused.py:_np_constants``,
    :73-77)."""
    taps, ah, aw = gaussian_constants(h, w, gaussian_sxy)
    return (ah[:, None] * band_matrix(h, taps) * ah[None, :],
            aw[:, None] * band_matrix(w, taps) * aw[None, :])


def to_bf16(a, device=None) -> torch.Tensor:
    """float64 values rounded to bf16 as ``jnp.asarray(a, jnp.bfloat16)``
    rounds them (through float32, as PyTorch's conversion does)."""
    return torch.as_tensor(np.asarray(a, np.float64), device=device).to(
        torch.bfloat16)


def bf16_tables(h: int, w: int, gaussian_sxy: float):
    """(wtab (W, 2r + 1), htab (H, 2r + 1)) float64, the bf16 kernel's view
    of the bands: ``wtab[x, t] = bandw[x + t - r, x]`` and ``htab[y, t] =
    bandh[y, y + t - r]``, 0 outside the map."""
    bandh, bandw = band_constants(h, w, gaussian_sxy)
    r = gaussian_taps(gaussian_sxy).shape[0] // 2

    def table(band, n, transpose):
        i = np.arange(n)[:, None]
        j = i + np.arange(2 * r + 1)[None, :] - r
        ok = (j >= 0) & (j < n)
        jc = np.clip(j, 0, n - 1)
        vals = band[jc, i] if transpose else band[i, jc]
        return np.where(ok, vals, 0.0)

    return table(bandw, w, True), table(bandh, h, False)


def _mean_field_bf16_plain(du, rgb, num_iters, gaussian_sxy, gaussian_compat,
                           bilateral_sxy, bilateral_srgb, bilateral_compat,
                           stride, closing_ksize) -> torch.Tensor:
    """The bf16 mode in plain PyTorch, written as JAX's ``_build_kmat`` and
    ``_mf_class`` (``simseg_tpu/ops/crf_fused.py:139-209``) are: the band,
    box, tile and K products of bf16 operands summed in float32 and rounded
    to bf16, every elementwise step in bf16. (B, K, H, W) bf16 masks."""
    bf = torch.bfloat16
    b, kk, h, w = du.shape
    s = stride
    hs, ws = h // s, w // s
    dev = du.device

    def mm(x, y):
        return torch.matmul(x.float(), y.float()).to(bf)

    bandh, bandw = (to_bf16(a, dev) for a in band_constants(h, w, gaussian_sxy))
    uh = to_bf16(np.arange(h)[:, None] // s == np.arange(hs)[None, :], dev)
    uw = to_bf16(np.arange(w)[:, None] // s == np.arange(ws)[None, :], dev)
    feat = bilateral_features(cell_colours(rgb, s), bilateral_sxy,
                              bilateral_srgb, s)
    kmat = bilateral_kernel_matrix(feat)                     # (B, N, N) f32
    bn = torch.rsqrt(kmat.sum(dim=1) + 1e-20).to(bf)[:, None, :]
    kmat = kmat.to(bf)
    gc, bc, half, scale = (to_bf16(x, dev) for x in (
        gaussian_compat, bilateral_compat, 0.5, 1.0 / (s * s)))
    du = du.float().to(bf)
    d = torch.tanh(du * half)
    for _ in range(num_iters):
        g = mm(bandh, mm(d, bandw))                          # Gaussian
        q = (mm(uh.T, mm(d, uw)) * scale).reshape(b, kk, hs * ws)
        m = mm(q * bn, kmat) * bn                            # bilateral
        fineb = mm(uh, mm(m.reshape(b, kk, hs, ws), uw.T))
        d = torch.tanh((du + gc * g + bc * fineb) * half)
    mask = (d > 0).to(bf)
    return closing(mask, closing_ksize) if closing_ksize > 1 else mask


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: one of {COMPUTE_DTYPES}")


def mean_field_fused_plain(du, rgb, num_iters=3, gaussian_sxy=3.0,
                           gaussian_compat=3.0, bilateral_sxy=40.0,
                           bilateral_srgb=13.0, bilateral_compat=10.0,
                           stride=8, closing_ksize=0,
                           compute_dtype="float32") -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: in float32 the
    CRF's materialised-K lane, (B, K, H, W) float32 masks; in bf16
    ``_mean_field_bf16_plain``, bf16 masks."""
    _check_dtype(compute_dtype)
    if compute_dtype == "bfloat16":
        return _mean_field_bf16_plain(
            du, rgb, num_iters, gaussian_sxy, gaussian_compat, bilateral_sxy,
            bilateral_srgb, bilateral_compat, stride, closing_ksize)
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
                                stride=8, closing_ksize=7,
                                compute_dtype="float32"):
    """The tail kernel's function in plain PyTorch: ``nearest_upsample`` of
    the patch-grid unaries by ``du_factor``, ``mean_field_fused_plain`` in
    ``compute_dtype`` with the closing, then masks * scores_eff in float32
    and the strict-'>' argmax of ``ops/seg_decode.decode_tail``. Returns
    (pred (B, H, W) int32, best_w (B, H, W) f32)."""
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    masks = mean_field_fused_plain(
        nearest_upsample(du_coarse.float(), du_factor), rgb,
        num_iters=num_iters, gaussian_sxy=gaussian_sxy,
        gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
        bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
        stride=stride, closing_ksize=closing_ksize,
        compute_dtype=compute_dtype).float()
    scores_eff = scores_eff.float()
    return decode_tail(masks, cand_idx, scores_eff,
                       torch.ones(scores_eff.shape, dtype=torch.bool,
                                  device=scores_eff.device))


@functools.lru_cache(maxsize=1)
def _library() -> types.SimpleNamespace:
    """The CRF kernels' entry points and error strings, from two libraries
    built side by side (one nvcc each, at once): ``csrc/crf_mean_field.cu``
    (float32) and ``csrc/crf_mean_field_bf16.cu`` (bf16)."""
    with ThreadPoolExecutor(2) as pool:
        f32, bf16 = pool.map(cuda_build.load_library, (_NAME, _BF16_NAME))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    args = {
        "crf_mean_field_f32": [
            p, p, i, p, p, p,            # du, rgb, rgb is uint8, taps, ah, aw
            i, i, i, i, i, i, i,         # B, K, H, W, stride, radius, iters
            f, f, f, f, i,               # compat g, compat b, sxy, srgb, closing k
            i, i, i,                     # tile h, tile w, shared bytes
            p, p, p, p],                 # work, barrier, out, stream
        "crf_decode_tail_f32": [
            p, p, i, p, p, p,            # du_coarse, rgb, uint8, taps, ah, aw
            p, p, i,                     # scores, cand_idx, cand_idx is int64
            i, i, i, i, i, i, i, i,      # B, K, H, W, factor, stride, radius,
                                         # iters
            f, f, f, f, i,               # compat g, compat b, sxy, srgb, closing k
            i, i, i,                     # tile h, tile w, shared bytes
            p, p, p, p, p],              # work, barrier, pred, best_w, stream
        "crf_mean_field_bf16": [
            p, p, i, p, p,               # du, rgb, rgb is uint8, wtab, htab
            i, i, i, i,                  # their interiors: wlo, whi, hlo, hhi
            i, i, i, i, i, i, i,         # B, K, H, W, stride, radius, iters
            f, f, f, f, f, i,            # compat g, compat b, scale, sxy, srgb,
                                         # closing k
            i, i, i,                     # tile h, tile w, shared bytes
            p, ll, p, p, p],             # work, its bytes, barrier, out, stream
        "crf_decode_tail_bf16": [
            p, p, i, p, p,               # du_coarse, rgb, uint8, wtab, htab
            i, i, i, i,                  # their interiors: wlo, whi, hlo, hhi
            p, p, i,                     # scores, cand_idx, cand_idx is int64
            i, i, i, i, i, i, i, i,      # B, K, H, W, factor, stride, radius,
                                         # iters
            f, f, f, f, f, i,            # compat g, compat b, scale, sxy, srgb,
                                         # closing k
            i, i, i,                     # tile h, tile w, shared bytes
            p, ll, p, p, p, p]}          # work, its bytes, barrier, pred,
                                         # best_w, stream
    fns = {}
    for name, argtypes in args.items():
        fn = getattr(bf16 if name.endswith("bf16") else f32, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    for lib, name in ((f32, _NAME), (bf16, _BF16_NAME)):
        fns[f"{name}_error_string"] = getattr(lib, f"{name}_error_string")
    fn = fns["crf_mean_field_bf16_phases"] = bf16.crf_mean_field_bf16_phases
    fn.argtypes, fn.restype = [i, i], None   # a profile by phase: lo, hi
    return types.SimpleNamespace(**fns)


class LaunchPlan(NamedTuple):
    """How the kernel cuts a call (the C side checks it): the update tile,
    whether its cells are whole (the splat fused into the update), and the
    shared memory per block."""
    tile_h: int
    tile_w: int
    fused_splat: bool
    smem_bytes: int


def _tile(stride: int):
    """The update tile: whole stride cells up to 32 x 64 (past that, 32 or
    64 and a separate splat); (tile_h, tile_w, fused_splat)."""
    tile_h = stride * (_TILE_H // stride) if stride <= _TILE_H else _TILE_H
    tile_w = stride * (_TILE_W // stride) if stride <= _TILE_W else _TILE_W
    return tile_h, tile_w, tile_h % stride == 0 and tile_w % stride == 0


def _close_words(h, w, num_classes, closing_ksize, tail):
    """Words of a closing band (``close_words`` of ``csrc/crf_common.cuh``):
    two copies of its rows and the closed band (the tail's K bands)."""
    words = -(-w // 32)
    k = max(closing_ksize, 1)
    return (2 * min(h, _BAND + 2 * (k - 1)) * words
            + (num_classes if tail else 1) * _BAND * words)


def launch_plan(h: int, w: int, stride: int, radius: int, num_classes: int,
                num_iters: int, closing_ksize: int, tail: bool = False) -> LaunchPlan:
    """The kernel's plan for a call, mirroring ``smem_need`` and
    ``tile_layout`` of ``csrc/crf_mean_field.cu``: the update tile
    (``_tile``), and the largest of an update tile with its radius-r halo, a
    message tile (features and K values of 512 cells), a closing band and a
    cell row's column sums."""
    tile_h, tile_w, fused = _tile(stride)
    thp, twp = -(-tile_h // _STRIP) * _STRIP, -(-tile_w // _STRIP) * _STRIP
    span = 2 * radius
    need = ((thp + span) * (((twp + span) | 1) + twp + 1)
            + 2 * (thp + span) + 2 * (twp + span) + thp
            + 2 * _MAX_RADIUS + 1 + thp * twp)
    if num_iters > 0:
        need = max(need, _CHUNK * (5 + num_classes), 3 * w)
    need = max(need, _close_words(h, w, num_classes, closing_ksize, tail))
    return LaunchPlan(tile_h, tile_w, fused, 4 * need)


def launch_plan_bf16(h: int, w: int, stride: int, radius: int,
                     num_classes: int, num_iters: int, closing_ksize: int,
                     tail: bool = False) -> LaunchPlan:
    """The bf16 kernel's plan, mirroring ``smem_need`` and ``tile_layout``
    of ``csrc/crf_mean_field_bf16.cu``: the float32 kernel's tile, and the
    largest of an update tile (the bf16 halo, rows of a pitch odd in words;
    the row pass's sums; the new d), a cell row's column sums, the
    bilateral rows' partial sums (8 warps x 128) and a closing band."""
    tile_h, tile_w, fused = _tile(stride)
    thp, twp = -(-tile_h // _STRIP) * _STRIP, -(-tile_w // _STRIP) * _STRIP
    span = 2 * radius
    cols = twp + span + 2
    pin = cols if cols % 4 else cols + 2
    prow = twp + 1
    need = (thp + span) * pin // 2 + (thp + span) * prow + thp * prow
    if num_iters > 0:
        need = max(need, 3 * w, _WARPS * 128)
    need = max(need, _close_words(h, w, num_classes, closing_ksize, tail))
    return LaunchPlan(tile_h, tile_w, fused, 4 * need)


def workspace_floats(b: int, k: int, h: int, w: int, stride: int) -> int:
    """Floats of the kernel's workspace: features (B, N, 8), bn (B, N), q
    and m (B, K, N), two iterates (B, K, H, W), the last one's mask bits
    (B, K, H, ceil(W / 32)) words."""
    n = (h // stride) * (w // stride)
    return b * n * 9 + 2 * b * k * n + 2 * b * k * h * w + b * k * h * (-(-w // 32))


def workspace_bytes_bf16(b: int, k: int, h: int, w: int, stride: int) -> int:
    """Bytes of the bf16 kernel's workspace, each part 256-aligned
    (``workspace_bytes`` of ``csrc/crf_mean_field_bf16.cu``): the features by
    cell pair (B, Np / 2, 12) f32, bn (B, Np) f32, m (B, K, N) f32, bn q
    (B, Np / 2, 8, 2) bf16, two bf16 iterates (B, K, H, Wp), the mask bits
    (B, K, H, ceil(W / 32)) words; Np is N rounded up to 16, Wp is W
    rounded up to even. No (B, N, N) kernel matrix: the kernel recomputes
    its rows."""
    def a(n):
        return -(-n // 256) * 256
    n = (h // stride) * (w // stride)
    npad = -(-n // 16) * 16
    px = b * k * h * (w + w % 2)
    return (a(b * npad * 24) + a(b * npad * 4) + a(b * k * n * 4)
            + a(b * npad * 16) + 2 * a(px * 2) + a(b * k * h * -(-w // 32) * 4))


def kernel_tables(h: int, w: int, gaussian_sxy: float):
    """The bf16 kernel's view of ``bf16_tables``, rounded to bf16:
    (wtab, htab) float32, each row's taps zero-padded to a multiple of 4
    (a row of float4) and 8 zero rows after the map's (a strip of outputs
    past the image's edge reads them), and for each the range (lo, hi) of
    rows around the middle row that hold its taps (the interior: a strip
    of 8 outputs within it takes one row of taps)."""
    def pad(t):
        n, taps = t.shape
        out = np.zeros((n + _STRIP, -(-taps // 4) * 4), np.float32)
        out[:n, :taps] = t
        return out

    def interior(t):
        mid = t.shape[0] // 2
        same = (t == t[mid]).all(axis=1)
        lo, hi = mid, mid
        while lo > 0 and same[lo - 1]:
            lo -= 1
        while hi + 1 < t.shape[0] and same[hi + 1]:
            hi += 1
        return lo, hi

    wt, ht = (to_bf16(t).float().numpy() for t in bf16_tables(h, w, gaussian_sxy))
    return pad(wt), pad(ht), interior(wt) + interior(ht)


@functools.lru_cache(maxsize=32)
def _device_tables(h: int, w: int, gaussian_sxy: float, device: torch.device):
    """``kernel_tables`` on ``device``, and the Gaussian's radius."""
    wt, ht, ranges = kernel_tables(h, w, gaussian_sxy)
    radius = gaussian_taps(gaussian_sxy).shape[0] // 2
    return (torch.from_numpy(wt).to(device), torch.from_numpy(ht).to(device),
            ranges, radius)


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
                     closing_ksize: int = 0,
                     compute_dtype: str = "float32") -> torch.Tensor:
    """Mean-field refinement (+ closing when ``closing_ksize > 1``).

    du:  (B, K, H, W) float32, contiguous: ``log(p + 1e-8) - log(1 - p + 1e-8)``.
    rgb: (B, H, W, 3) images on du's device, 0..255 scale, any dtype.
    compute_dtype: ``"float32"`` or ``"bfloat16"`` (the TPU kernel's
    default; du is rounded to bf16 on reading).
    Returns (B, K, H, W) 0/1 masks in ``compute_dtype``.
    """
    _check_dtype(compute_dtype)
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
    if du.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CRF path for device {du.device}")
    return crf_mean_field(du, rgb, num_iters, float(gaussian_sxy),
                          float(gaussian_compat), float(bilateral_sxy),
                          float(bilateral_srgb), float(bilateral_compat),
                          stride, closing_ksize, compute_dtype)


@torch.library.custom_op("simseg::crf_mean_field", mutates_args=(),
                         device_types=("cpu", "cuda"))
def crf_mean_field(du: torch.Tensor, rgb: torch.Tensor, num_iters: int,
                   gaussian_sxy: float, gaussian_compat: float,
                   bilateral_sxy: float, bilateral_srgb: float,
                   bilateral_compat: float, stride: int,
                   closing_ksize: int,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """The op of ``mean_field_fused`` (arguments as it takes them): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    kw = dict(num_iters=num_iters, gaussian_sxy=gaussian_sxy,
              gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
              bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
              stride=stride, closing_ksize=closing_ksize)
    if du.device.type == "cuda":
        if compute_dtype == "bfloat16":
            return _mean_field_cuda_bf16(du, rgb, **kw)
        return _mean_field_cuda(du, rgb, **kw)
    return mean_field_fused_plain(du, rgb, compute_dtype=compute_dtype,
                                  **kw).contiguous()


@crf_mean_field.register_fake
def _(du, rgb, num_iters, gaussian_sxy, gaussian_compat, bilateral_sxy,
      bilateral_srgb, bilateral_compat, stride, closing_ksize,
      compute_dtype="float32"):
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return du.new_empty(du.shape, dtype=dtype)


def _mean_field_cuda(du, rgb, num_iters, gaussian_sxy, gaussian_compat,
                     bilateral_sxy, bilateral_srgb, bilateral_compat, stride,
                     closing_ksize):
    """The mean-field kernel on du's card, on the current stream."""
    b, kk, h, w = du.shape
    if kk > _MAX_CLASSES:
        raise ValueError(f"{kk} maps per image; the kernel takes <= {_MAX_CLASSES}")
    lib = _library()
    du = du.float().contiguous()
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


def _bf16_launch_inputs(du, rgb, b, kk, h, w, stride, gaussian_sxy,
                        gaussian_compat, bilateral_compat, num_iters,
                        closing_ksize, tail):
    """(wtab, htab, their interior ranges, radius, rgb as the kernel reads
    it, gc, bc and 1 / s^2 rounded to bf16, plan, workspace, its bytes,
    barrier, stream) of a bf16 call on du's card."""
    dev = du.device
    wtab, htab, ranges, radius = _device_tables(h, w, float(gaussian_sxy), dev)
    if radius > _MAX_RADIUS:
        raise ValueError(f"Gaussian radius {radius} > {_MAX_RADIUS}")
    if kk > _MAX_CLASSES:
        raise ValueError(f"{kk} maps per image; the kernel takes <= {_MAX_CLASSES}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        rgb = rgb.float()
    consts = [float(to_bf16(x)) for x in (gaussian_compat, bilateral_compat,
                                          1.0 / (stride * stride))]
    plan = launch_plan_bf16(h, w, stride, radius, kk, num_iters,
                            closing_ksize, tail)
    nbytes = workspace_bytes_bf16(b, kk, h, w, stride)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (wtab, htab, ranges, radius, rgb.contiguous(), consts, plan, work,
            nbytes, _barrier(dev, stream), stream)


def _mean_field_cuda_bf16(du, rgb, num_iters, gaussian_sxy, gaussian_compat,
                          bilateral_sxy, bilateral_srgb, bilateral_compat,
                          stride, closing_ksize):
    """The bf16 mean-field kernel on du's card, on the current stream."""
    b, kk, h, w = du.shape
    lib = _library()
    du = du.float().contiguous()
    (wtab, htab, ranges, radius, rgb, (gc, bc, scale), plan, work, nbytes,
     barrier, stream) = _bf16_launch_inputs(du, rgb, b, kk, h, w, stride, gaussian_sxy,
                                   gaussian_compat, bilateral_compat, num_iters,
                                   closing_ksize, False)
    out = torch.empty(du.shape, dtype=torch.bfloat16, device=du.device)
    with torch.cuda.device(du.device):
        status = lib.crf_mean_field_bf16(
            du.data_ptr(), rgb.data_ptr(), int(rgb.dtype == torch.uint8),
            wtab.data_ptr(), htab.data_ptr(), *ranges, b, kk, h, w, stride,
            radius, num_iters, gc, bc, scale, float(bilateral_sxy),
            float(bilateral_srgb), int(closing_ksize), plan.tile_h, plan.tile_w,
            plan.smem_bytes, work.data_ptr(), nbytes, barrier.data_ptr(),
            out.data_ptr(), stream)
    cuda_build.check_status(lib, _BF16_NAME, "crf_mean_field_bf16", status)
    global BF16_LAUNCHES
    BF16_LAUNCHES += 1
    return out


def seg_decode_tail_fused(du_coarse: torch.Tensor, rgb: torch.Tensor,
                          scores_eff: torch.Tensor, cand_idx: torch.Tensor,
                          du_factor: int, num_iters: int = 3,
                          gaussian_sxy: float = 3.0,
                          gaussian_compat: float = 3.0,
                          bilateral_sxy: float = 40.0,
                          bilateral_srgb: float = 13.0,
                          bilateral_compat: float = 10.0, stride: int = 8,
                          closing_ksize: int = 7,
                          compute_dtype: str = "float32"):
    """Mean-field CRF + closing + score-weighted argmax in one kernel.

    du_coarse:  (B, K, H/f, W/f) f32 patch-grid unary difference (f =
                ``du_factor``), nearest-upsampled inside the kernel.
    rgb:        (B, H, W, 3) images on du_coarse's device, 0..255 scale.
    scores_eff: (B, K) f32 candidate scores, 0 where the candidate is
                invalid (``where(valid, cand_scores, 0)``).
    cand_idx:   (B, K) class ids.
    compute_dtype: the mean field's, ``"float32"`` or ``"bfloat16"``.
    Returns (pred (B, H, W) int32, 0 where no weight is positive, and
    best_w (B, H, W) f32), the unfused chain's results.
    """
    _check_dtype(compute_dtype)
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode tail for device {dev}")
    return crf_decode_tail(du_coarse, rgb, scores_eff, cand_idx, du_factor,
                           num_iters, float(gaussian_sxy),
                           float(gaussian_compat), float(bilateral_sxy),
                           float(bilateral_srgb), float(bilateral_compat),
                           stride, closing_ksize, compute_dtype)


@torch.library.custom_op("simseg::crf_decode_tail", mutates_args=(),
                         device_types=("cpu", "cuda"))
def crf_decode_tail(du_coarse: torch.Tensor, rgb: torch.Tensor,
                    scores_eff: torch.Tensor, cand_idx: torch.Tensor,
                    du_factor: int, num_iters: int, gaussian_sxy: float,
                    gaussian_compat: float, bilateral_sxy: float,
                    bilateral_srgb: float, bilateral_compat: float,
                    stride: int, closing_ksize: int,
                    compute_dtype: str = "float32"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op of ``seg_decode_tail_fused`` (arguments as it takes them):
    the tail kernel on a CUDA tensor, the plain version on a CPU one."""
    kw = dict(num_iters=num_iters, gaussian_sxy=gaussian_sxy,
              gaussian_compat=gaussian_compat, bilateral_sxy=bilateral_sxy,
              bilateral_srgb=bilateral_srgb, bilateral_compat=bilateral_compat,
              stride=stride, closing_ksize=closing_ksize)
    if du_coarse.device.type == "cuda":
        cuda = (_decode_tail_cuda_bf16 if compute_dtype == "bfloat16"
                else _decode_tail_cuda)
        return cuda(du_coarse, rgb, scores_eff, cand_idx, du_factor, **kw)
    pred, best_w = seg_decode_tail_fused_plain(
        du_coarse, rgb, scores_eff, cand_idx, du_factor,
        compute_dtype=compute_dtype, **kw)
    return pred.contiguous(), best_w.contiguous()


@crf_decode_tail.register_fake
def _(du_coarse, rgb, scores_eff, cand_idx, du_factor, num_iters,
      gaussian_sxy, gaussian_compat, bilateral_sxy, bilateral_srgb,
      bilateral_compat, stride, closing_ksize, compute_dtype="float32"):
    b, _, gh, gw = du_coarse.shape
    shape = (b, gh * du_factor, gw * du_factor)
    return (du_coarse.new_empty(shape, dtype=torch.int32),
            du_coarse.new_empty(shape, dtype=torch.float32))


def _decode_tail_cuda(du_coarse, rgb, scores_eff, cand_idx, du_factor,
                      num_iters, gaussian_sxy, gaussian_compat, bilateral_sxy,
                      bilateral_srgb, bilateral_compat, stride, closing_ksize):
    """The tail kernel on du_coarse's card, on the current stream."""
    b, kk, gh, gw = du_coarse.shape
    h, w = gh * du_factor, gw * du_factor
    dev = du_coarse.device
    if kk > _MAX_CLASSES:
        raise ValueError(f"{kk} maps per image; the kernel takes <= {_MAX_CLASSES}")
    lib = _library()
    du_coarse = du_coarse.float().contiguous()
    scores_eff, cand_idx = _tail_operands(scores_eff, cand_idx)
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


def _tail_operands(scores_eff, cand_idx):
    if cand_idx.dtype not in (torch.int32, torch.int64):
        cand_idx = cand_idx.to(torch.int32)
    return scores_eff.float().contiguous(), cand_idx.contiguous()


def _decode_tail_cuda_bf16(du_coarse, rgb, scores_eff, cand_idx, du_factor,
                           num_iters, gaussian_sxy, gaussian_compat,
                           bilateral_sxy, bilateral_srgb, bilateral_compat,
                           stride, closing_ksize):
    """The bf16 tail kernel on du_coarse's card, on the current stream."""
    b, kk, gh, gw = du_coarse.shape
    h, w = gh * du_factor, gw * du_factor
    dev = du_coarse.device
    lib = _library()
    du_coarse = du_coarse.float().contiguous()
    scores_eff, cand_idx = _tail_operands(scores_eff, cand_idx)
    (wtab, htab, ranges, radius, rgb, (gc, bc, scale), plan, work, nbytes,
     barrier, stream) = _bf16_launch_inputs(du_coarse, rgb, b, kk, h, w, stride,
                                   gaussian_sxy, gaussian_compat,
                                   bilateral_compat, num_iters, closing_ksize,
                                   True)
    pred = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    best_w = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.crf_decode_tail_bf16(
            du_coarse.data_ptr(), rgb.data_ptr(), int(rgb.dtype == torch.uint8),
            wtab.data_ptr(), htab.data_ptr(), *ranges, scores_eff.data_ptr(),
            cand_idx.data_ptr(), int(cand_idx.dtype == torch.int64), b, kk, h,
            w, du_factor, stride, radius, num_iters, gc, bc, scale,
            float(bilateral_sxy), float(bilateral_srgb), int(closing_ksize),
            plan.tile_h, plan.tile_w, plan.smem_bytes, work.data_ptr(), nbytes,
            barrier.data_ptr(), pred.data_ptr(), best_w.data_ptr(), stream)
    cuda_build.check_status(lib, _BF16_NAME, "crf_decode_tail_bf16", status)
    global BF16_TAIL_LAUNCHES
    BF16_TAIL_LAUNCHES += 1
    return pred, best_w

