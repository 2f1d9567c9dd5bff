"""Streaming bilateral matrix-vector product as a hand-written CUDA kernel
(port of ``simseg_tpu/ops/crf_pallas.py``; the module keeps its
counterpart's name).

``bilateral_matvec_batched(feat (B, N, F), q (B, N, C))`` returns
out[b] = K_b q[b] with K_b[i, j] = exp(-0.5 max(|f_i|^2 + |f_j|^2 -
2 f_i.f_j, 0)), the expanded distance the TPU kernel uses (:34-53,
:100-121); ``bilateral_matvec`` is its B = 1 case. A ones column for q
gives the degree K 1. On a CUDA tensor the wrapper launches
``csrc/bilateral_matvec.cu`` or raises — there is no fallback; on a CPU
tensor it runs ``bilateral_matvec_plain``. ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from simseg_tpu_torch.ops import cuda_build

__all__ = ["LAUNCHES", "bilateral_matvec", "bilateral_matvec_batched",
           "bilateral_matvec_plain"]

_NAME = "bilateral_matvec"  # csrc/bilateral_matvec.cu
_F_PAD = 8       # kFeat in the kernel
_MAX_C = 8       # the kernel's template instances: C = 1..8
_ROW_TILE = 512  # rows of K the plain version holds at a time

# launches of the CUDA kernel (one per bilateral_matvec(_batched) call on
# the card)
LAUNCHES = 0


def bilateral_matvec_plain(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32: (B, N, F), (B, N, C)
    -> (B, N, C), over row tiles of 512 so that at most B x 512 x N floats
    of K exist at once."""
    feat, q = feat.float(), q.float()
    sq = (feat * feat).sum(dim=-1)                                # (B, N)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
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
    fn.argtypes = [p, p, p, i, i, i, p]   # feat, q, out, B, N, C, stream
    fn.restype = ctypes.c_int
    return lib


def bilateral_matvec_batched(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """out[b, i] = sum_j exp(-0.5 |f_bi - f_bj|^2) q[b, j]: feat (B, N, F)
    with F <= 8, q (B, N, C) -> (B, N, C) float32."""
    if feat.dim() != 3 or q.dim() != 3 or q.shape[:2] != feat.shape[:2]:
        raise ValueError(f"feat (B, N, F) and q (B, N, C) expected, got "
                         f"{tuple(feat.shape)} and {tuple(q.shape)}")
    if feat.device != q.device:
        raise ValueError(f"feat on {feat.device} but q on {q.device}")
    if feat.device.type == "cpu":
        return bilateral_matvec_plain(feat, q)
    if feat.device.type != "cuda":
        raise ValueError(f"no bilateral path for device {feat.device}")
    b, n, f = feat.shape
    c = q.shape[2]
    if f > _F_PAD:
        raise ValueError(f"{f} features; the kernel takes <= {_F_PAD}")
    if not 1 <= c <= _MAX_C:
        raise ValueError(f"{c} columns of q; the kernel takes 1..{_MAX_C}")
    lib = _library()
    feat = F.pad(feat.float(), (0, _F_PAD - f)).contiguous()
    q = q.float().contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=q.device)
    status = lib.bilateral_matvec_f32(
        feat.data_ptr(), q.data_ptr(), out.data_ptr(), b, n, c,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_status(lib, _NAME, "bilateral_matvec_f32", status)
    global LAUNCHES
    LAUNCHES += 1
    return out


def bilateral_matvec(feat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unbatched ``bilateral_matvec_batched``: (N, F), (N, C) -> (N, C)."""
    return bilateral_matvec_batched(feat[None], q[None])[0]
