"""Token pooling: masked average and LoDA top-k pooling, L2 norm (port of
``simseg_tpu/ops/pooling.py``).

Parity: reference ``simseg/models/components/pooling.py`` — AvgPooling
(:7-19) and TopKPooling (:42-65): per channel, the mean of the k largest
token activations; masked positions are pushed to -10000 first and k is
clamped to the shortest valid sequence in the batch. The clamp stays a
tensor (no host sync): the static top-k is taken and only its first
``k_eff`` entries are averaged, as in the JAX version.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK_FILL = -10000.0


def avg_pool(x: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the token dim (axis 1); mask-weighted when given."""
    if attention_mask is None:
        return x.mean(dim=1)
    mask = attention_mask[..., None].to(x.dtype)
    return (x * mask).sum(dim=1) / mask.sum(dim=1)


def topk_pool(x: torch.Tensor, k: int,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LoDA top-k pooling over the token dim: (B, T, D) -> (B, D)."""
    k = min(k, x.shape[1])
    if attention_mask is not None:
        x = x.masked_fill(attention_mask[..., None] <= 0, _MASK_FILL)
        min_len = (attention_mask > 0).sum(dim=1).min()
        k_eff = torch.clamp(min_len, max=k)
    else:
        k_eff = torch.tensor(k, device=x.device)
    vals = torch.topk(x.transpose(1, 2), k, dim=-1, sorted=True).values
    keep = (torch.arange(k, device=x.device) < k_eff).to(x.dtype)
    return (vals * keep).sum(dim=-1) / k_eff.to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps), the semantics of ``F.normalize``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
