"""Layers that compute in their input's dtype whatever their parameters'
dtype: the JAX towers' mixed-precision policy.

flax keeps float32 parameters and casts them to the compute dtype at each
op (``Dense(dtype=bf16)``, ``LayerNorm(dtype=bf16)``; ``param_dtype`` stays
float32). These subclasses do the same, under the names and state-dict
keys of ``nn.Linear`` and ``nn.LayerNorm``: a model keeps float32 master
parameters and runs in bf16 when its activations are bf16, and
``model.to(torch.bfloat16)`` still works (the casts are then no-ops).
``torch.autocast`` is not used: its op list keeps LayerNorm and softmax in
float32 where the JAX bf16 lane does not.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU in float32, the tanh approximation in lower precision
    (the JAX towers' rule, ``simseg_tpu/models/vit.py:56``)."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


class Linear(nn.Linear):
    """``x W^T + b`` in x's dtype, W and b cast to it at use (flax ``Dense``
    with ``dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """Statistics, scale and shift in float32, the result in x's dtype
    (flax ``LayerNorm`` with ``dtype``). With parameters already in x's
    dtype, PyTorch's own kernel does just that (it normalises in float32
    inside), without the casts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)
