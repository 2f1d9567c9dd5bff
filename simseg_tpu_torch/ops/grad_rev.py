"""Gradient reversal (port of ``simseg_tpu/ops/grad_rev.py``).

Parity: reference ``simseg/models/components/grad_rev.py:4-31`` (RevGrad:
the identity forward, the gradient negated and scaled by ``alpha`` in the
backward; part of the component surface, unused by the registered
pipelines).
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -ctx.alpha * grad, None


def grad_reverse(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``x`` unchanged; its gradient comes back as ``-alpha`` times the
    incoming one."""
    return _GradReverse.apply(x, alpha)
