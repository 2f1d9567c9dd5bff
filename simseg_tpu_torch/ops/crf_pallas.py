"""Streaming bilateral matrix-vector product as a hand-written CUDA kernel
(port of ``simseg_tpu/ops/crf_pallas.py``; the module keeps its
counterpart's name).

``bilateral_matvec_batched(feat (B, N, F), q (B, N, C))`` returns
out[b] = K_b q[b] with K_b[i, j] = exp(-0.5 |f_i - f_j|^2);
``bilateral_matvec`` is its B = 1 case. A ones column for q gives the
degree K 1. The product is the custom op ``simseg::bilateral_matvec``: on
a CUDA tensor it launches ``csrc/bilateral_matvec.cu`` (the product over
column chunks, then the fixed-order sum of the chunks' partial sums) or
raises — there is no fallback; on a CPU tensor it runs
``bilateral_matvec_plain`` in float32. ``LAUNCHES`` counts the calls that
launched the kernel, inside the op's CUDA implementation. ``launch_plan`` is
how the kernel cuts a call (warps per CTA, the column split, shared
memory, workspace); the kernel refuses a plan that does not match its own
count.

The plain version keeps the TPU kernel's expanded distance
max(|f_i|^2 + |f_j|^2 - 2 f_i.f_j, 0) (:34-53, :100-121), so that the CPU
tests hold it against JAX; the CUDA kernel sums squared differences, which
do not cancel in float32, and is held against the plain version run in
float64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from simseg_tpu_torch.ops import cuda_build

__all__ = ["LAUNCHES", "LaunchPlan", "bilateral_matvec",
           "bilateral_matvec_batched", "bilateral_matvec_op",
           "bilateral_matvec_plain", "launch_plan"]

_NAME = "bilateral_matvec"  # csrc/bilateral_matvec.cu
# the kernel's cuts (csrc/bilateral_matvec.cu): rows a warp holds (kRows = 6
# a thread), column cells per staged tile, tile stages, columns of q per
# group, features
_WARP_ROWS = 192
_TILE = 64
_STAGES = 2
_GROUP = 8
_MAX_F = 8
_ROW_TILE = 512  # rows of K the plain version holds at a time
# four warps per CTA, sharing each staged tile; the column split aims at 4
# warps per SM of an H100 (132 SMs) for one image, one per warp scheduler
_WARPS = 4
_FILL_WARPS = 4 * 132

# launches of the CUDA kernel (one per bilateral_matvec(_batched) call on
# the card)
LAUNCHES = 0


class LaunchPlan(NamedTuple):
    warps: int             # warps per CTA, 192 rows each
    row_tiles: int
    chunks: int            # S, the column chunks: a function of N alone
    chunk_cells: int       # cells per chunk (the last may hold fewer)
    groups: int            # column groups of at most 8
    grid: tuple            # (row_tiles x chunks, B, groups)
    smem_bytes: int        # dynamic shared memory per CTA
    workspace_floats: int  # partial sums (G, B, S, CW, N)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, n: int, f: int, c: int) -> LaunchPlan:
    """The kernel's plan for B images of N cells, F features and C columns,
    mirroring ``bilateral_matvec_f32``'s checks: CTAs of four 192-row warps
    (the last row tile's warps past N only stage tiles); the columns in S
    chunks of at least one tile, S so that one image's grid holds
    ``_FILL_WARPS`` warps. S depends on N only, so image b's sums are taken
    in the same order at every batch."""
    fk = 5 if f == 5 else _MAX_F
    cw = min(c, _GROUP)
    groups = -(-c // _GROUP)
    row_tiles = -(-n // (_WARPS * _WARP_ROWS))
    want = -(-_FILL_WARPS // -(-n // _WARP_ROWS))
    chunk_cells = max(_TILE, -(-n // want))
    chunks = -(-n // chunk_cells)
    return LaunchPlan(
        _WARPS, row_tiles, chunks, chunk_cells, groups,
        (row_tiles * chunks, b, groups),
        _STAGES * _TILE * (-(-(fk + cw) // 4) * 4) * 4,
        groups * b * chunks * cw * n)


def bilateral_matvec_plain(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (B, N, F), (B, N, C) ->
    (B, N, C), over row tiles of 512 so that at most B x 512 x N floats of
    K exist at once. Float32, or float64 where either input is float64
    (the reference the kernel is held against on the card)."""
    dtype = torch.promote_types(torch.promote_types(feat.dtype, q.dtype),
                                torch.float32)
    feat, q = feat.to(dtype), q.to(dtype)
    sq = (feat * feat).sum(dim=-1)                                # (B, N)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    for i0 in range(0, feat.shape[1], _ROW_TILE):
        fi = feat[:, i0:i0 + _ROW_TILE]
        d2 = (sq[:, i0:i0 + _ROW_TILE, None] + sq[:, None, :]
              - 2.0 * torch.matmul(fi, feat.transpose(1, 2)))
        k = torch.exp(-0.5 * torch.clamp(d2, min=0.0))
        out[:, i0:i0 + _ROW_TILE] = torch.matmul(k, q)
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.bilateral_matvec_f32
    ll = ctypes.c_longlong
    # feat, q, q's strides (batch, cell, column), out, workspace and its
    # floats, B, N, F, C, warps, chunks, chunk cells, shared memory, stream
    fn.argtypes = [p, p, ll, ll, ll, p, p, ll] + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return lib


def bilateral_matvec_batched(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """out[b, i] = sum_j exp(-0.5 |f_bi - f_bj|^2) q[b, j]: feat (B, N, F)
    with F <= 8, q (B, N, C) -> (B, N, C) float32. On the card q is read
    through its strides (a transposed view costs no copy) and nothing is
    launched but the kernel and its chunk sum."""
    if feat.dim() != 3 or q.dim() != 3 or q.shape[:2] != feat.shape[:2]:
        raise ValueError(f"feat (B, N, F) and q (B, N, C) expected, got "
                         f"{tuple(feat.shape)} and {tuple(q.shape)}")
    if feat.device != q.device:
        raise ValueError(f"feat on {feat.device} but q on {q.device}")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bilateral path for device {feat.device}")
    return bilateral_matvec_op(feat, q)


@torch.library.custom_op("simseg::bilateral_matvec", mutates_args=(),
                         device_types=("cpu", "cuda"))
def bilateral_matvec_op(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The op of ``bilateral_matvec_batched``: (B, N, C) float32, the kernel
    on a CUDA tensor, the plain version on a CPU one."""
    if feat.device.type == "cuda":
        return _matvec_cuda(feat, q)
    return bilateral_matvec_plain(feat.float(), q.float())


@bilateral_matvec_op.register_fake
def _(feat, q):
    return q.new_empty(q.shape, dtype=torch.float32)


def _matvec_cuda(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel on feat's card, on the current stream, q read through its
    strides."""
    b, n, f = feat.shape
    c = q.shape[2]
    if not 1 <= f <= _MAX_F:
        raise ValueError(f"{f} features; the kernel takes 1 to <= {_MAX_F}")
    if c < 1:
        raise ValueError(f"{c} columns of q; the kernel takes >= 1")
    lib = _library()
    feat = feat.float().contiguous()
    q = q.float()
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = launch_plan(b, n, f, c)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    work = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    status = lib.bilateral_matvec_f32(
        feat.data_ptr(), q.data_ptr(), *q.stride(), out.data_ptr(),
        work.data_ptr(), work.numel(), b, n, f, c, plan.warps, plan.chunks,
        plan.chunk_cells, plan.smem_bytes, stream)
    cuda_build.check_status(lib, _NAME, "bilateral_matvec_f32", status)
    global LAUNCHES
    LAUNCHES += 1
    return out


def bilateral_matvec(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unbatched ``bilateral_matvec_batched``: (N, F), (N, C) -> (N, C)."""
    return bilateral_matvec_batched(feat[None], q[None])[0]
