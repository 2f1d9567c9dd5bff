"""Int8 post-training quantisation of the towers' linear layers (port of
``simseg_tpu/ops/quant.py``). Inference only: ``round`` has no gradient, and
the runner refuses ``quant`` under training.

``quant='int8'``: weights symmetric per output channel (scale_w[n] =
max|W[n, :]| / 127), activations symmetric per token, computed on the fly;
y = acc · sx · sw + b.

``quant='int8_static'``: a calibration sweep (``cache_quant_state``) keeps a
running a[k] = max|x[..., k]| per input channel; a/127 is folded into the
weights before their per-output-channel quantisation (SmoothQuant style),
so the forward quantises activations with one multiply, round and clip, and
dequantises with the weight scale alone: y = acc · sw + b.

Both accumulate int8 × int8 in int32 through ``torch._int_mm`` (exact on the
CPU and on the card), add the float32 bias and cast to the input's dtype.
On the card ``_int_mm`` takes more than 16 rows and K and N that are
multiples of 8; a call of 16 rows or fewer is padded with zero rows (exact),
any other shape it refuses raises: no int8 call falls back to a float
product. The weight is kept (N, K) int8 contiguous and passed transposed,
the operand layout cuBLASLt's int8 product takes without a copy.

Weight caching: ``QuantLinear`` keeps the int8 weight, ``w_scale`` and
``x_absmax`` in non-persistent buffers, so ``state_dict()`` and checkpoint
loading do not change; they are derived state, rebuilt by every
``cache_quant_state`` call, and must be rebuilt after loading other weights.
Without the cache, ``int8`` quantises the float32 weight on every call and
``int8_static`` raises. In a ``torch.distributed`` world the ranks
calibrate on different shards, so one calibration must win:
``broadcast_quant_state`` gives every rank rank 0's.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterable, Optional

import torch

from simseg_tpu_torch.models.layers import Linear

_EPS = 1e-12
_MIN_ROWS = 17  # _int_mm on the card wants more than 16 rows


def quantize_rowwise(x: torch.Tensor):
    """Symmetric int8 along the last axis: (q int8 like x, scale float32
    shaped x.shape[:-1] + (1,)), q · scale ~= x. The divide and round run in
    float32 whatever x's dtype (JAX ``quantize_rowwise``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=_EPS))
    return q.to(torch.int8), scale


def quantize_colwise(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a (N, K) weight (the port's
    ``Linear`` layout; JAX's kernel is its transpose): the max runs over K.
    Returns (q (N, K) int8, scale (N,) float32)."""
    wf = w.float()
    scale = wf.abs().amax(dim=1) / 127.0
    q = torch.round(wf / torch.clamp(scale, min=_EPS)[:, None])
    return q.to(torch.int8), scale


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) @ int8 (N, K)^T -> int32 (..., N), exact."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    rows = x2.shape[0]
    if rows < _MIN_ROWS:
        x2 = torch.cat([x2, x2.new_zeros((_MIN_ROWS - rows, k))])
    if x2.is_cuda and (k % 8 or wq.shape[0] % 8):
        raise ValueError(f"the int8 product takes K and N in multiples of 8 "
                         f"on the card, got K = {k}, N = {wq.shape[0]}")
    return torch._int_mm(x2, wq.t())[:rows].reshape(*lead, wq.shape[0])


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dynamic per-token quantised x @ W^T (+ bias): x (..., K) any float,
    (wq, sw) from ``quantize_colwise``; rank-1 dequant acc · sx · sw, the
    float32 bias added, cast to ``out_dtype`` (default x's)."""
    xq, sx = quantize_rowwise(x)
    y = int8_mm(xq, wq).float() * sx * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


def int8_matmul_static(x: torch.Tensor, rcp_a: torch.Tensor,
                       wq: torch.Tensor, sw: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Static quantised product: rcp_a = 127 / a per input channel, (wq, sw)
    the folded weights; x quantised by clip(round(x · rcp_a), -127, 127),
    dequantised by acc · sw."""
    xq = torch.clamp(torch.round(x.float() * rcp_a), -127.0, 127.0)
    y = int8_mm(xq.to(torch.int8), wq).float() * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


class QuantLinear(Linear):
    """``Linear`` with an int8 forward, under the same parameter names and
    state-dict keys (quantisation is a forward transform of the float32
    master weights, which it requires).

    Buffers (non-persistent, None until ``cache_quant_state`` fills them):
    ``weight_q`` (N, K) int8, ``w_scale`` (N,) float32 and, for the static
    mode, ``x_absmax`` (K,) float32. While ``calibrating`` (set by
    ``cache_quant_state``) a call raises the running absmax with its input
    and re-folds the weights, so the last call bakes the whole sweep, as a
    JAX forward with the ``'quant'`` collection mutable does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 static_acts: bool = False) -> None:
        super().__init__(in_features, out_features, bias)
        self.static_acts = static_acts
        self.calibrating = False
        for name in ("weight_q", "w_scale", "x_absmax"):
            self.register_buffer(name, None, persistent=False)

    def clear_quant_state(self) -> None:
        self.weight_q = self.w_scale = self.x_absmax = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype != torch.float32:
            raise TypeError(
                f"QuantLinear quantises float32 master weights, got "
                f"{self.weight.dtype}: keep the parameters float32 and set "
                "the model's compute_dtype")
        if self.static_acts:
            if self.calibrating:
                amax = x.detach().float().abs().reshape(-1, x.shape[-1]).amax(0)
                if self.x_absmax is not None:
                    amax = torch.maximum(self.x_absmax, amax)
                self.x_absmax = amax
                a = torch.clamp(amax, min=1e-6)
                self.weight_q, self.w_scale = quantize_colwise(
                    self.weight.detach() * (a / 127.0))
            elif self.weight_q is None:
                raise RuntimeError(
                    "quant='int8_static' needs calibration: run "
                    "ops.quant.cache_quant_state(...) on the loaded model "
                    "before inference")
            a = torch.clamp(self.x_absmax, min=1e-6)
            # a tensor division: ``127.0 / a`` would run as 127 · (1 / a),
            # two roundings where JAX has one
            rcp_a = torch.full_like(a, 127.0) / a
            return int8_matmul_static(x, rcp_a, self.weight_q, self.w_scale,
                                      self.bias)
        if self.weight_q is not None:
            wq, sw = self.weight_q, self.w_scale
        else:
            wq, sw = quantize_colwise(self.weight.detach())
            if self.calibrating:
                self.weight_q, self.w_scale = wq, sw
        return int8_matmul(x, wq, sw, self.bias)


def quant_layers(model: torch.nn.Module):
    """The ``QuantLinear`` modules of ``model``, by name."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, QuantLinear)}


@torch.no_grad()
def cache_quant_state(model: torch.nn.Module,
                      calls: Iterable[Callable[[], object]]) -> torch.nn.Module:
    """Rebuild every ``QuantLinear``'s cached int8 weights and, for
    ``int8_static``, its calibrated activation absmax (JAX
    ``cache_quant_state``): drops any cached state, then runs ``calls`` (each
    a function of no arguments that runs the model forward) in order with the
    layers calibrating. Use calls that touch every quantised tower; for
    ``int8_static``, representative batches. Returns ``model``."""
    layers = quant_layers(model).values()
    for layer in layers:
        layer.clear_quant_state()
        layer.calibrating = True
    try:
        for call in calls:
            call()
    finally:
        for layer in layers:
            layer.calibrating = False
    return model


def broadcast_quant_state(model: torch.nn.Module) -> torch.nn.Module:
    """Every ``QuantLinear``'s cached int8 weights, scales and absmax made
    rank 0's on every rank of a ``torch.distributed`` world (JAX
    ``simseg_tpu/tasks/seg_eval.py:149-157``: process 0's calibration
    broadcast); nothing without a world. Every rank must call it."""
    from simseg_tpu_torch.parallel.collectives import broadcast_object
    from simseg_tpu_torch.parallel.mesh import is_distributed, rank

    layers = quant_layers(model)
    if not is_distributed() or not layers:
        return model
    names = ("weight_q", "w_scale", "x_absmax")
    state = None
    if rank() == 0:
        state = {n: {k: None if getattr(m, k) is None else getattr(m, k).cpu()
                     for k in names} for n, m in layers.items()}
    state = broadcast_object(state)
    for n, m in layers.items():
        for k in names:
            v = state[n][k]
            setattr(m, k, None if v is None else v.to(m.weight.device))
    return model


def linear_cls(quant: Optional[str]):
    """Linear-layer factory for the ``quant`` arch knob: '' / 'none' ->
    ``Linear``, 'int8' -> ``QuantLinear`` (dynamic activations),
    'int8_static' -> ``QuantLinear`` with calibrated static scales."""
    if quant in (None, "", "none"):
        return Linear
    if quant == "int8":
        return QuantLinear
    if quant == "int8_static":
        return partial(QuantLinear, static_acts=True)
    raise NotImplementedError(
        f"quant='{quant}' (supported: 'none', 'int8', 'int8_static')")
