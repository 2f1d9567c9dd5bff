"""Fused bias-free attention as a hand-written CUDA kernel (port of
``simseg_tpu/ops/flash_attention.py:flash_mha``).

``flash_mha(qh, kh, vh)`` takes (B, T, H, hd) tensors with q pre-scaled by
hd^-1/2 and returns softmax(q k^T) v in the same layout and q's dtype. On a
CUDA tensor it launches ``csrc/flash_attention.cu`` or raises — there is no
fallback; on a CPU tensor it runs ``flash_mha_plain``. Its backward
recomputes through the plain version, as the JAX ``custom_vjp`` does
(:179-198). ``LAUNCHES`` counts the kernel's launches.

``flash_supported`` is the JAX gate, copied as it is: its band
(1024 <= T <= 1536) was measured on a TPU, not on this card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from simseg_tpu_torch.ops import cuda_build

__all__ = ["LAUNCHES", "flash_mha", "flash_mha_plain", "flash_supported"]

_NAME = "flash_attention"  # csrc/flash_attention.cu
_HEAD_DIMS = (64, 128, 192, 256)  # the kernel's template instances

# the whole-T TPU kernel's VMEM ceiling (JAX ``_MAX_T``)
_MAX_T = 1536

# launches of the CUDA kernel (one per flash_mha call on the card)
LAUNCHES = 0


def flash_supported(tq: int, tk: int, hd: int, dtype, attention_bias) -> bool:
    """JAX ``flash_supported`` (``simseg_tpu/ops/flash_attention.py:838-861``):
    no bias, not float32, 1024 <= Tq, Tk <= 1536, hd a multiple of 64 up to
    256."""
    if attention_bias is not None:
        return False
    if dtype == torch.float32:
        return False
    if not (1024 <= tq <= _MAX_T and 1024 <= tk <= _MAX_T):
        return False
    return hd % 64 == 0 and hd <= 256


def flash_mha_plain(qh: torch.Tensor, kh: torch.Tensor,
                    vh: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (JAX ``_reference_mha``,
    :167-176): float32 scores from the operands, max-subtracted softmax in
    float32, p cast to v's dtype, p v accumulated in float32, output in q's
    dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(vh.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh.float())
    return out.to(qh.dtype)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes = [p, p, p, p,            # q, k, v, o
                   i, i, i, i, i,         # B, Tq, Tk, H, hd
                   p, p]                  # strides (12 int64), stream
    fn.restype = ctypes.c_int
    return lib


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: unit head-dim stride, 16-byte aligned
    rows. The ViT's q, k, v already are (k and v are views into the fused
    qkv output); anything else is copied once."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3])):
        return x
    return x.contiguous()


def _launch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    b, tq, h, hd = qh.shape
    tk = kh.shape[1]
    for name, x in (("k", kh), ("v", vh)):
        if x.shape != (b, tk, h, hd):
            raise ValueError(f"{name} must be {(b, tk, h, hd)}, got {tuple(x.shape)}")
        if x.dtype != qh.dtype or x.device != qh.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; q is "
                             f"{qh.dtype} on {qh.device}")
    if qh.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {qh.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd}; the kernel takes {_HEAD_DIMS}")
    lib = _library()
    qh, kh, vh = (_kernel_operand(x) for x in (qh, kh, vh))
    out = torch.empty((b, tq, h, hd), dtype=qh.dtype, device=qh.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (qh, kh, vh, out) for s in x.stride()[:3]))
    status = lib.flash_attention_fwd_bf16(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), b, tq, tk,
        h, hd, ctypes.addressof(strides),
        torch.cuda.current_stream(qh.device).cuda_stream)
    cuda_build.check_status(lib, _NAME, "flash_attention_fwd_bf16", status)
    global LAUNCHES
    LAUNCHES += 1
    return out


class _FlashMHA(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain version's gradients, recomputed from q, k, v (flash-style: no
    (T, T) tensor is saved)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        ctx.save_for_backward(qh, kh, vh)
        if qh.device.type == "cpu":
            return flash_mha_plain(qh, kh, vh)
        if qh.device.type != "cuda":
            raise ValueError(f"no attention kernel for device {qh.device}")
        return _launch(qh, kh, vh)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
            out = flash_mha_plain(*leaves)
        return torch.autograd.grad(out, leaves, g)


def flash_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Attention on (B, T, H, hd) inputs, q pre-scaled by hd^-1/2 ->
    (B, Tq, H, hd) in q's dtype (kernel: bfloat16, hd in 64/128/192/256)."""
    if qh.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(qh.shape)}")
    return _FlashMHA.apply(qh, kh, vh)
