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

The CNN towers' layers (``Conv2d``, ``BatchNorm``, ``same_pad``) follow
flax's ``nn.Conv`` and ``nn.BatchNorm`` on NCHW tensors (``models/resnet.py``,
``convnext.py``, ``efficientnet.py``).

Also the towers' dropout and rematerialisation. A dropout key is a
threefry key (``utils/threefry.py``: two uint32 words) that the caller
passes down the forward; each ``Dropout`` site folds its own number into
it and seeds a generator of its own from the result, as flax folds a
module's path into the ``dropout`` rng. No site touches a shared
generator, so a recompute (``remat``) or a second forward with the same
key (BSGS's pass 2) draws the same masks: ``torch.utils.checkpoint``'s
``preserve_rng_state`` restores only the default generators, which no site
uses. Over ranks the step folds the rank into the key
(``engine/train_step.rank_key``), so no two data ranks share a mask; the
ranks of a model group share it, each site of a sharded tensor keeping its
slice of the whole mask (``Dropout.feature_shard`` / ``seq``). ``remat`` runs a block under ``torch.utils.checkpoint.checkpoint``
in its non-reentrant form, whose first forward keeps grad mode on (the
reentrant form would run it under ``no_grad``, and the attention would
take the inference lane there and the train lane in the recompute).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.utils import threefry


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU in float32, the tanh approximation in lower precision
    (the JAX towers' rule, ``simseg_tpu/models/vit.py:56``)."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


def whole_param(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole, for a forward that reads a
    child's parameter: gathered from its shards where FSDP shards it
    (``parallel/sharding.py``; a collective of the gather group)."""
    fsdp = module.__dict__.get("_fsdp")
    if fsdp is not None and name in fsdp:
        from simseg_tpu_torch.parallel.collectives import gather_param

        return gather_param(module._parameters[name], *fsdp[name])
    return getattr(module, name)


class Linear(nn.Linear):
    """``x W^T + b`` in x's dtype, W and b cast to it at use (flax ``Dense``
    with ``dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x, self.bias)

    def product(self, x: torch.Tensor, bias) -> torch.Tensor:
        """``x W^T`` (+ ``bias``); a weight that FSDP shards is gathered for
        the product and again for its backward (``parallel/sharding.py``)."""
        fsdp = self.__dict__.get("_fsdp")
        if fsdp is not None and "weight" in fsdp:
            from simseg_tpu_torch.parallel.sharding import gathered_linear

            return gathered_linear(x, self._parameters["weight"], bias,
                                   fsdp["weight"])
        return F.linear(x, self.weight.to(x.dtype),
                        None if bias is None else bias.to(x.dtype))


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


class Conv2d(nn.Conv2d):
    """A convolution in x's dtype, its weight and bias cast at use (flax
    ``Conv`` with ``dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` (N, C, H, W) zero-padded as flax's ``padding='SAME'`` pads it
    for a ``kernel`` x ``kernel`` window at ``stride``: out = ceil(in /
    stride), the missing rows split low = total // 2, high = the rest. Where
    the size divides the stride and kernel == stride this is no padding,
    torch's ``padding=0``; elsewhere torch would drop the last rows."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW tensor, under timm's ``BatchNorm2d`` names (``weight``,
    ``bias``, ``running_mean``, ``running_var``; ``num_batches_tracked`` is
    kept for the reference's layout and never counts, as flax keeps no
    count).

    ``forward(x, train_bn=False)``: with the running statistics, the
    result in x's dtype (``F.batch_norm``, which normalises in float32).
    With ``train_bn`` (flax ``use_running_average=False``), the batch's
    statistics in float32 whatever x's dtype: mean = E[x] and the biased
    var = max(E[x^2] - E[x]^2, 0), gradients flowing through them; the
    running buffers move as flax moves them, ``momentum * old + (1 -
    momentum) * batch`` with that biased var (PyTorch's
    ``F.batch_norm(training=True)`` would take the unbiased var, and calls
    flax's 0.9 ``momentum=0.1``). In a ``torch.distributed`` world of more
    than one rank the sums are taken over the data ranks (``sync``; the
    world without tensor parallelism: synchronised BN, JAX's forward under
    pjit sees the global batch), and their gradients are summed over them
    in the backward."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9) -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        # (group, ranks) the statistics are summed over: None, the world;
        # a model group's ranks hold the same rows, so tensor parallelism
        # sets the data ranks (parallel/sharding.py)
        self.sync = None

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        if not train_bn:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        from simseg_tpu_torch.parallel.collectives import all_reduce_sum_grad
        from simseg_tpu_torch.parallel.mesh import world_size

        xf = x.float()
        sums = torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
        count = float(x.numel() // x.shape[1])
        group, n = self.sync if self.sync is not None else (None, world_size())
        if n > 1:
            sums = all_reduce_sum_grad(sums, group)
            count *= n
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.float()[:, None, None]).to(x.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` with an explicit key: each entry kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the rest zero. The
    mask comes from a generator seeded from ``fold_in(key, site)``, where
    ``site`` is this module's number in its model
    (``number_dropout_sites``). Without a key (the deterministic forward)
    or at rate 0 it is the identity."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)
        self.site = 0
        # a tensor-parallel site holds a slice of what one process drops
        # out: (ranks, rank) of its last dim (a column-parallel output), or
        # the token slice of a sequence-parallel tower (``parallel/tp.py:
        # SeqParallel``); it draws the whole mask and keeps its slice
        self.feature_shard: Optional[tuple] = None
        self.seq = None

    def forward(self, x: torch.Tensor,
                key: Optional[threefry.Key] = None) -> torch.Tensor:
        if key is None or self.rate <= 0.0:
            return x
        k = threefry.fold_in(key, self.site)
        gen = torch.Generator(device=x.device)
        gen.manual_seed((k[0] << 32) | k[1])
        shape = list(x.shape)
        if self.feature_shard is not None:
            shape[-1] *= self.feature_shard[0]
        if self.seq is not None:
            shape[1] = self.seq.tokens
        keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - self.rate
        if self.seq is not None:
            first, rows = self.seq.rows()
            pad = first + rows - keep.shape[1]
            if pad > 0:
                keep = torch.cat([keep, keep.new_ones(
                    (shape[0], pad) + tuple(shape[2:]))], dim=1)
            keep = keep.narrow(1, first, rows)
        if self.feature_shard is not None:
            n = x.shape[-1]
            keep = keep.narrow(-1, self.feature_shard[1] * n, n)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def number_dropout_sites(module: nn.Module) -> None:
    """Numbers the ``Dropout`` sites of ``module`` 0, 1, ... in module
    order, so that each draws its own mask from one key."""
    sites = (m for m in module.modules() if isinstance(m, Dropout))
    for i, m in enumerate(sites):
        m.site = i


def parse_remat_policy(name: Optional[str]) -> str:
    """'none' (recompute the whole block) or 'dots' (JAX's
    ``dots_with_no_batch_dims_saveable``: keep the weight products, recompute
    the rest), the JAX tower's ``_remat_policy`` names."""
    if name in (None, "", "none"):
        return "none"
    if name == "dots":
        return "dots"
    raise NotImplementedError(f"remat_policy '{name}'")


def _keep_weight_products(ctx, op, *args, **kwargs):
    """The 'dots' policy: ``mm`` / ``addmm`` (the linears, whose products
    have no batch dimension) saved; batched products (``bmm``: the plain
    attention's scores and mix), elementwise ops and the attention kernels
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (non-reentrant checkpoint; ``policy`` from ``parse_remat_policy``)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _keep_weight_products)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      **kwargs)

def refuse_moe(arch: Optional[dict], tower: str) -> None:
    """JAX's MoE towers (``moe_experts > 0``, ``ops/moe.py``) are not ported:
    refuse them by name rather than fail on an unknown keyword."""
    experts = dict(arch or {}).get("moe_experts", 0)
    if int(experts or 0) > 0:
        raise NotImplementedError(
            f"the {tower} tower's arch moe_experts={experts} (MoE towers, "
            "ops/moe.py) is not ported yet: ROADMAP item 13")
