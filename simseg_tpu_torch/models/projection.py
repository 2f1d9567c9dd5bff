"""Projection heads to the shared embedding space (port of
``simseg_tpu/models/projection.py``).

Parity: reference ``simseg/components/projection.py`` —
SimpleProjection (:29-46, one bias-free Linear) and ComplexProjection
(:3-27, Linear -> GELU -> Linear -> Dropout -> residual -> LayerNorm). Both
compute in their input's dtype (``models/layers.py``). The complex head's
dropout is applied only when ``deterministic`` is False, as the JAX train
step asks for it (``runner.stable_random`` set).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import LayerNorm, Linear, gelu


class SimpleProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int) -> None:
        super().__init__()
        self.linear = Linear(in_dim, projection_dim, bias=False)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return self.linear(x)


class ComplexProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int,
                 dropout: float = 0.1) -> None:
        super().__init__()
        self.dropout = dropout
        self.projection = Linear(in_dim, projection_dim)
        self.fc = Linear(projection_dim, projection_dim)
        # flax LayerNorm's default epsilon
        self.layer_norm = LayerNorm(projection_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        projected = self.projection(x)
        y = self.fc(gelu(projected))
        if not deterministic and self.dropout > 0:
            y = F.dropout(y, self.dropout, training=True)
        return self.layer_norm(y + projected)
