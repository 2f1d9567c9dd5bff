"""Projection heads to the shared embedding space (port of
``simseg_tpu/models/projection.py``).

Parity: reference ``simseg/models/components/projection.py`` —
SimpleProjection (:29-46, one bias-free Linear) and ComplexProjection
(:3-27, Linear -> GELU -> Linear -> residual -> LayerNorm). Inference only:
the complex head's dropout is the identity here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU in float32, the tanh approximation in lower precision
    (the JAX towers' rule, ``simseg_tpu/models/vit.py:56``)."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


class SimpleProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(in_dim, projection_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class ComplexProjection(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int) -> None:
        super().__init__()
        self.projection = nn.Linear(in_dim, projection_dim)
        self.fc = nn.Linear(projection_dim, projection_dim)
        # flax LayerNorm's default epsilon
        self.layer_norm = nn.LayerNorm(projection_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = self.projection(x)
        y = self.fc(gelu(projected))
        return self.layer_norm(y + projected)
