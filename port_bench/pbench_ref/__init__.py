"""The benchmark's plain reference: PyTorch only, nothing of the program,
of JAX or of the JAX package. ``precise`` runs a block with TF32 off, so
float32 products are float32; ``FP8Hybrid`` is the control: fp8
training's roundings, one step below the bf16 the configurations state."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precise():
    """Float32 matrix products and convolutions in full float32 (no TF32)
    inside the block, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude to 448), back in x's dtype: the operand rounding
    of an fp8 product, one step below the bf16 the configuration states."""
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    # the rounding has no gradient of its own: pass the gradient straight
    return x + (q - x).detach()


def _e5m2(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / 57344.0  # float8 e5m2's largest
    return (x / scale).to(torch.float8_e5m2).to(x.dtype) * scale


class _GradE5M2(torch.autograd.Function):
    """The identity forward; the gradient rounded to float8 e5m2 under one
    scale for the tensor on its way back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _e5m2(g)


class FP8Hybrid:
    """fp8 training's hybrid recipe, the fp8 step a training program would
    take: every product's operands in e4m3 (``fp8``), and the gradient that
    reaches each product's output in e5m2 before the backward's products
    use it."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x)

    @staticmethod
    def out(y: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(y) if y.requires_grad else y
