"""Multi-head attention core (port of the plain path of
``simseg_tpu/ops/attention.py:85-106``).

The JAX package routes long bias-free bf16 sequences (T >= 1024) to its
Pallas flash kernels; the segmentation main path (T = 325 image tokens,
padded BERT text) never reaches them, so the port has only this path:
matmul + softmax with q pre-scaled.
"""

from __future__ import annotations

from typing import Optional

import torch


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
    qh = q.reshape(b, tq, num_heads, hd).transpose(1, 2)   # (B, H, Tq, hd)
    kh = k.reshape(b, tk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, tk, num_heads, hd).transpose(1, 2)
    # the 1/sqrt(hd) scale in q's own dtype, as the JAX version folds it
    qh = qh * torch.tensor(float(hd), dtype=dtype, device=q.device).pow(-0.5)

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
