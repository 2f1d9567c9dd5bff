"""Multi-head attention core (port of ``simseg_tpu/ops/attention.py``).

Two lowerings, routed as the JAX package routes them (:108-182):
- bias-free, non-float32 calls on a CUDA tensor with ``flash_supported``
  (1024 <= T <= 1536, hd % 64 == 0: the 576-px ViT pass of multi-scale
  segmentation) go to the hand-written kernel ``ops/flash_attention.py``;
- everything else takes the plain path: matmul + softmax with q
  pre-scaled. That includes the CPU (where the JAX package's
  ``platform_dependent`` default is its einsum path too) and, until their
  kernels are ported, the JAX rowblock (T > 1680) and stream (T > 4096)
  bands.
"""

from __future__ import annotations

from typing import Optional

import torch

from simseg_tpu_torch.ops import flash_attention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int,
                         attention_bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q, k, v: (B, T, D), D = num_heads * head_dim -> (B, Tq, D).

    attention_bias: additive, broadcastable to (B, H, Tq, Tk). The compute
    dtype is q's: float32 gives the exact softmax; bf16 mirrors the JAX bf16
    lane (scores kept in bf16, max-subtracted exp, normaliser summed in f32).
    """
    b, tq, d = q.shape
    tk = k.shape[1]
    if d % num_heads != 0:
        raise ValueError(f"model dim {d} not divisible by num_heads {num_heads}")
    hd = d // num_heads
    dtype = q.dtype
    # the 1/sqrt(hd) scale in q's own dtype, as the JAX version folds it
    qh = q.reshape(b, tq, num_heads, hd) * torch.tensor(
        float(hd), dtype=dtype, device=q.device).pow(-0.5)
    kh = k.reshape(b, tk, num_heads, hd)
    vh = v.reshape(b, tk, num_heads, hd)

    if q.device.type == "cuda" and flash_attention.flash_supported(
            tq, tk, hd, dtype, attention_bias):
        return flash_attention.flash_mha(qh, kh, vh).reshape(b, tq, d)

    qh, kh, vh = (x.transpose(1, 2) for x in (qh, kh, vh))  # (B, H, T, hd)
    scores = torch.matmul(qh, kh.transpose(-2, -1))        # (B, H, Tq, Tk)
    if attention_bias is not None:
        scores = scores + attention_bias.to(scores.dtype)
    if dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1)
    else:
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        s = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
        probs = (e / s.to(e.dtype)).to(dtype)
    out = torch.matmul(probs, vh)                          # (B, H, Tq, hd)
    return out.transpose(1, 2).reshape(b, tq, d).to(dtype)


def padding_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """HF-style additive mask: (B, Tk) 0/1 -> (B, 1, 1, Tk), 0 to keep and
    -1e9 for padded keys."""
    bias = (1.0 - attention_mask.float()) * -1e9
    return bias[:, None, None, :].to(dtype)
