"""Projection heads to the shared embedding space (port of
``simseg_tpu/models/projection.py``).

Parity: reference ``simseg/components/projection.py`` —
SimpleProjection (:29-46, one bias-free Linear) and ComplexProjection
(:3-27, Linear -> GELU -> Linear -> Dropout -> residual -> LayerNorm). Both
compute in their input's dtype (``models/layers.py``). The complex head's
dropout is applied only when the caller passes a dropout key, as the JAX
train step passes an rng (``runner.stable_random`` set).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from simseg_tpu_torch.models.layers import Dropout, LayerNorm, Linear, gelu


class SimpleProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int) -> None:
        super().__init__()
        self.linear = Linear(in_dim, projection_dim, bias=False)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return self.linear(x)


class ComplexProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int,
                 dropout: float = 0.1) -> None:
        super().__init__()
        self.projection = Linear(in_dim, projection_dim)
        self.fc = Linear(projection_dim, projection_dim)
        self.drop = Dropout(dropout)
        # flax LayerNorm's default epsilon
        self.layer_norm = LayerNorm(projection_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        projected = self.projection(x)
        y = self.drop(self.fc(gelu(projected)), key)
        return self.layer_norm(y + projected)
