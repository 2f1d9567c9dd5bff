"""Multi-head attention core (port of ``simseg_tpu/ops/attention.py``).

Five lowerings, routed as the JAX package routes them (:134-180), in its
order, by ``attention_lane``:
- a call that will be differentiated and passes ``flash_train_supported``
  (bias-free, not float32, self-attention with 1024 <= T <= 1536, hd % 64
  == 0: the 576-px ViT pass in training) goes to ``flash_mha_train``, whose
  forward and backward are both hand-written kernels;
- a call that passes ``flash_rowblock_supported`` (the same shapes with
  1536 < T <= 4096 when differentiated, 1680 < T <= 4096 in inference: the
  640-px training crop, the 720-px view of multi-scale segmentation) goes
  to ``flash_mha_rowblock``;
- one that passes ``flash_stream_supported`` (T > 4096: the 1152-px view)
  to ``flash_mha_stream``;
- one that passes ``flash_supported`` (1024 <= T <= 1536: the 576-px pass
  of multi-scale segmentation) to ``flash_mha`` (the forward kernel);
- everything else takes the plain path: matmul + softmax with q
  pre-scaled. That includes the CPU, where the JAX package's
  ``platform_dependent`` default is its einsum path too, biased calls
  (BERT's padding mask), and inference at 1536 < T <= 1680, below the
  TPU's measured row-block crossover.

"Will be differentiated" is the JAX ``attention_training()`` marker
(:25-37); here autograd knows it: grad mode is on and q, k or v requires
grad. Evaluation therefore runs under ``torch.no_grad()`` to keep its lane.
"""

from __future__ import annotations

from typing import Optional

import torch

from simseg_tpu_torch.ops import flash_attention


def attention_lane(b: int, num_heads: int, tq: int, tk: int, hd: int, dtype,
                   attention_bias, training: bool) -> str:
    """'train', 'rowblock', 'stream', 'flash' or 'plain': the lane the JAX
    package takes on its accelerator for this call (checked in its
    order)."""
    fa = flash_attention
    if training and fa.flash_train_supported(b, num_heads, tq, tk, hd, dtype,
                                             attention_bias):
        return "train"
    if fa.flash_rowblock_supported(tq, tk, hd, dtype, attention_bias,
                                   training):
        return "rowblock"
    if fa.flash_stream_supported(tq, tk, hd, dtype, attention_bias):
        return "stream"
    if fa.flash_supported(tq, tk, hd, dtype, attention_bias):
        return "flash"
    return "plain"


# the lanes that run a kernel on the card, by wrapper name
_KERNEL_LANES = {"train": "flash_mha_train", "rowblock": "flash_mha_rowblock",
                 "stream": "flash_mha_stream", "flash": "flash_mha"}


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
    # (a 0-dim host tensor: an operand of a CUDA op without a copy)
    qh = q.reshape(b, tq, num_heads, hd) * torch.tensor(
        float(hd), dtype=dtype).pow(-0.5)
    kh = k.reshape(b, tk, num_heads, hd)
    vh = v.reshape(b, tk, num_heads, hd)

    training = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    lane = attention_lane(b, num_heads, tq, tk, hd, dtype, attention_bias,
                          training)
    if q.device.type == "cuda" and lane in _KERNEL_LANES:
        kernel = getattr(flash_attention, _KERNEL_LANES[lane])
        return kernel(qh, kh, vh).reshape(b, tq, d)

    qh, kh, vh = (x.transpose(1, 2) for x in (qh, kh, vh))  # (B, H, T, hd)
    scores = torch.matmul(qh, kh.transpose(-2, -1))        # (B, H, Tq, Tk)
    if attention_bias is not None:
        scores = scores + attention_bias.to(scores.dtype)
    if dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1)
    else:
        m = scores.amax(dim=-1, keepdim=True).detach()  # JAX stop_gradient
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
