"""Where each parameter and optimizer moment lives: tensor parallelism,
FSDP and ZeRO-1 applied to a model (port of ``simseg_tpu/engine/
train_step.py:92-186``, ``opt_state_sharding`` and
``derive_state_shardings``, over ``simseg_tpu/parallel/tp.py``).

``shard_model(model, mesh, tp=, sp=, fsdp=, zero1=)`` computes a
``ParamSpec`` for every parameter by the ported rules (``parallel/tp.py``)
and cuts each rank's parameters down to its shard, so that a rank holds
only its part of the state:

- TP: the rule-matching linears of the ViT blocks and BERT layers become
  column- / row-parallel (their rows or columns of the model group); with
  ``sp`` the image tower's stream is sliced by tokens between blocks;
- FSDP: every parameter of at least 2^14 elements keeps its 1/n of the
  largest free dim that n divides, n the data ranks of a gather group
  (JAX's 'data' axis), on top of TP's dim where both apply. Weights are
  gathered just in time: ``Linear`` products gather their weight in the
  forward and again in the backward (``gathered_linear``: the gathered
  weight is not kept between the two), every other read of such a
  parameter in its module's own forward gathers through the module's
  attribute (``gather_param``; outside that forward the attribute is the
  shard, and a forward that reads a child's weight gathers it with
  ``models/layers.whole_param``), and a remat recompute gathers again;
  gradients are reduce-scattered into the shards in the backward;
- EP (``dist.moe_ep``): an MoE layer's expert weights, their expert dim
  over the data ranks of a gather group when the expert count divides them
  (JAX ``ep_shardings``, which wins over FSDP on those leaves); the layer
  then runs its experts on every rank's tokens between two all-to-alls
  (``ops/moe.py``);
- ZeRO-1: the optimizer's moments of a parameter the TP, FSDP and EP rules
  left whole, of at least 2^16 elements, over all data ranks: the
  optimizer steps a view of the rank's slice of the parameter
  (``core/optim.py``).

A checkpoint holds the whole parameters and moments, the layout a
data-parallel run writes: ``full_state_dict`` gathers them (a collective:
every rank calls it; a rank that does not write drops each tensor once
gathered) and ``load_full_state_dict`` cuts a whole state down
to this rank's shards, so a state written by one leg resumes onto any.

Gradients: ``reduce_model_gradients`` sums them over the data ranks
(replicated and TP-sharded leaves; FSDP's were reduce-scattered in the
backward; EP's already hold every rank's tokens, and are summed over the
gather groups' peers only), after summing the sequence-parallel leaves'
token-slice parts over the model group. Under pipeline parallelism
(``parallel/pp.py``) every rank holds every parameter and each leaf's
gradient is taken from the one stage that computes it (its blocks' stage;
the embeddings' stage 0; the rest, which every stage computes alike, the
last stage's): the other stages' are zeroed before the sum over the
world, so no leaf counts a stage twice. ``grad_sq_norm`` counts each
element of the gradient once over the world, for clipping and the log.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from simseg_tpu_torch.models.layers import BatchNorm, Linear, whole_param
from simseg_tpu_torch.parallel.collectives import (_BUCKET_BYTES, _all_reduce_,
                                                   all_reduce_sum, gather_dim,
                                                   reduce_gradients,
                                                   reduce_scatter_dim)
from simseg_tpu_torch.parallel.mesh import DataMesh
from simseg_tpu_torch.parallel.tp import (ColumnParallelLinear, ParamSpec,
                                          RowParallelLinear, SeqParallel,
                                          ep_dim, fsdp_dim, layout_order,
                                          tp_dim, zero1_dim)

logger = logging.getLogger(__name__)

FSDP_MIN_SIZE = 2**14
ZERO1_MIN_SIZE = 2**16


@dataclass
class ShardPlan:
    """The specs of a sharded model's parameters, by name, and its mesh."""
    mesh: DataMesh
    specs: Dict[str, ParamSpec] = field(default_factory=dict)
    tp: int = 1
    fsdp: bool = False
    zero1: bool = False
    ep: bool = False

    # -- whole <-> shard ---------------------------------------------------
    def local(self, full: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        """This rank's shard of the whole tensor ``full``."""
        m = self.mesh
        t = full
        if spec.tp_dim is not None:
            t = torch.cat([c.chunk(m.tp, spec.tp_dim)[m.model_rank]
                           for c in t.chunk(spec.tp_chunks, spec.tp_dim)],
                          spec.tp_dim)
        if spec.data_dim is not None:
            t = t.chunk(m.group_ranks, spec.data_dim)[m.rank_in_group]
        return t.contiguous()

    def full(self, local: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        """The whole tensor from every rank's shard (a collective over the
        groups the spec shards over)."""
        m = self.mesh
        t = local.detach()
        if spec.data_dim is not None:
            t = gather_dim(t, spec.data_dim, m.gather_group)
        if spec.tp_dim is not None:
            parts = gather_dim(t, spec.tp_dim, m.model_group).chunk(
                m.tp, spec.tp_dim)
            chunks = [p.chunk(spec.tp_chunks, spec.tp_dim) for p in parts]
            t = torch.cat([chunks[r][j] for j in range(spec.tp_chunks)
                           for r in range(m.tp)], spec.tp_dim)
        return t

    def zero_view(self, full: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        """This data rank's ZeRO-1 slice of ``full``, a view of it."""
        m = self.mesh
        size = full.shape[spec.zero_dim] // m.data_size
        return full.narrow(spec.zero_dim, m.data_rank * size, size)

    def zero_local(self, full: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        return self.zero_view(full, spec).contiguous()

    def zero_full(self, local: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        return gather_dim(local.detach(), spec.zero_dim, self.mesh.data_group)

    def index(self, spec: ParamSpec, zero: bool = False):
        """Where this rank's part lies in the whole tensor: per dim of the
        whole (``spec.shape``), the whole indices of the part's positions,
        in order (numpy int64), so that ``whole[np.ix_(*index)]`` is
        ``local(whole, spec)``, or with ``zero`` ``zero_local(whole,
        spec)``. A checkpoint writes and reads parts by these indices, no
        rank gathering another's part."""
        m = self.mesh
        idx = [np.arange(n) for n in spec.shape]
        if zero:
            d = spec.zero_dim
            size = spec.shape[d] // m.data_size
            idx[d] = idx[d][m.data_rank * size:(m.data_rank + 1) * size]
            return idx
        if spec.tp_dim is not None:
            d, c = spec.tp_dim, spec.tp_chunks
            chunk = spec.shape[d] // c
            part = chunk // m.tp
            idx[d] = np.concatenate([np.arange(j * chunk + m.model_rank * part,
                                               j * chunk + (m.model_rank + 1) * part)
                                     for j in range(c)])
        if spec.data_dim is not None:
            d = spec.data_dim
            size = len(idx[d]) // m.group_ranks
            idx[d] = idx[d][m.rank_in_group * size:(m.rank_in_group + 1) * size]
        return idx

    def owns(self, spec: Optional[ParamSpec]) -> bool:
        """Whether this rank counts its shard of the parameter once over the
        world (the first rank of every axis the parameter is replicated
        over; under pipeline parallelism every stage holds the same summed
        gradient, and stage 0 counts it)."""
        m = self.mesh
        if m.stage != 0:
            return False
        if (spec is None or spec.tp_dim is None) and m.model_rank != 0:
            return False
        if spec is not None and spec.data_dim is not None:
            return m.replica == 0
        return m.data_rank == 0

    @property
    def sharded_grads(self) -> bool:
        """Whether some rank holds only a part of some gradient."""
        return any(s.tp_dim is not None or s.data_dim is not None
                   for s in self.specs.values())


def plan_of(model: nn.Module) -> Optional[ShardPlan]:
    return getattr(model, "shard_plan", None)


def _kind(module: nn.Module, leaf: str) -> str:
    if leaf != "weight":
        return "other"
    if isinstance(module, nn.Linear):
        return "linear"
    if isinstance(module, nn.Conv2d):
        return "conv"
    return "other"


def _owners(model: nn.Module) -> Iterator[Tuple[str, nn.Module, str]]:
    """(parameter name, owning module, its attribute) of every parameter."""
    for mod_name, module in model.named_modules():
        for leaf in list(module._parameters):
            if module._parameters[leaf] is not None:
                yield (f"{mod_name}.{leaf}" if mod_name else leaf, module,
                       leaf)


# -- tensor and sequence parallelism -------------------------------------------

def _tp_ok(specs: Dict[str, ParamSpec], names, tp: int) -> bool:
    """A block is sharded when every leaf the rules shard (``names``: its
    weights and column biases) divides (else it stays replicated as a
    whole)."""
    return all(tp_dim(n, specs[n].shape, tp) is not None for n in names
               if n in specs)


@dataclass
class _TpLayout:
    """What tensor parallelism changes in a model: the linears made
    column- (``chunks`` parts sharded each) or row-parallel, the modules
    whose heads are split, the MLPs whose hidden dropout is sliced, and the
    image tower's blocks (with whether each is sharded whole)."""
    linears: list = field(default_factory=list)   # (prefix, module, cls, chunks)
    heads: list = field(default_factory=list)     # ViT Attention / BertLayer
    mlps: list = field(default_factory=list)
    vit_blocks: list = field(default_factory=list)  # (prefix, block, sharded)


def _tp_layout(model: nn.Module, specs: Dict[str, ParamSpec],
               tp: int) -> _TpLayout:
    from simseg_tpu_torch.models.vit import VisionTransformer

    out = _TpLayout()
    col, row = ColumnParallelLinear, RowParallelLinear
    image = getattr(model, "image_tower", None)
    if isinstance(image, VisionTransformer):
        for i, block in enumerate(image.blocks):
            pre = f"image_encoder.model.model.blocks.{i}"
            # an MoE block's experts stay whole (JAX's rules match no
            # MoE leaf): the block is not sharded whole
            attn, mlp = block.attn, getattr(block, "mlp", None)
            attn_ok = (type(attn.qkv) is Linear and attn.num_heads % tp == 0
                       and _tp_ok(specs, [f"{pre}.attn.qkv.weight",
                                          f"{pre}.attn.qkv.bias",
                                          f"{pre}.attn.proj.weight"], tp))
            if attn_ok:
                out.linears += [(f"{pre}.attn.qkv", attn.qkv, col, 3),
                                (f"{pre}.attn.proj", attn.proj, row, 1)]
                out.heads.append(attn)
            mlp_ok = (mlp is not None and type(mlp.fc1) is Linear
                      and _tp_ok(specs, [f"{pre}.mlp.fc1.weight",
                                         f"{pre}.mlp.fc1.bias",
                                         f"{pre}.mlp.fc2.weight"], tp))
            if mlp_ok:
                out.linears += [(f"{pre}.mlp.fc1", mlp.fc1, col, 1),
                                (f"{pre}.mlp.fc2", mlp.fc2, row, 1)]
                out.mlps.append(mlp)
            out.vit_blocks.append((pre, block, attn_ok and mlp_ok))
    bert = getattr(model, "bert", None)
    if bert is not None:
        for i, layer in enumerate(bert.encoder.layer):
            pre = f"text_encoder.model.model.encoder.layer.{i}"
            sa = layer.attention.self
            qkv = [f"{pre}.attention.self.{n}" for n in ("query", "key", "value")]
            if (type(sa.query) is Linear and layer.num_heads % tp == 0
                    and _tp_ok(specs, [f"{n}.{leaf}" for n in qkv
                                       for leaf in ("weight", "bias")]
                               + [f"{pre}.attention.output.dense.weight"], tp)):
                out.linears += [(n, getattr(sa, n.rsplit(".", 1)[1]), col, 1)
                                for n in qkv]
                out.linears.append((f"{pre}.attention.output.dense",
                                    layer.attention.output.dense, row, 1))
                out.heads.append(layer)
            if (hasattr(layer, "intermediate")
                    and type(layer.intermediate.dense) is Linear
                    and _tp_ok(specs, [f"{pre}.intermediate.dense.weight",
                                       f"{pre}.intermediate.dense.bias",
                                       f"{pre}.output.dense.weight"], tp)):
                out.linears += [(f"{pre}.intermediate.dense",
                                 layer.intermediate.dense, col, 1),
                                (f"{pre}.output.dense", layer.output.dense,
                                 row, 1)]
    return out


def _sp_on(model: nn.Module, layout: _TpLayout) -> bool:
    """Whether the image tower's stream can be sliced by tokens: every
    block sharded whole and no token-merging carry. Otherwise the blocks
    run on the whole stream, which gives the same numbers (JAX's
    constraint is a layout)."""
    blocks = layout.vit_blocks
    return (bool(blocks) and all(ok for _, _, ok in blocks)
            and not model.image_tower.tome_on)


def _sp_partial_names(layout: _TpLayout):
    for pre, _, _ in layout.vit_blocks:
        yield from (f"{pre}.norm1.weight", f"{pre}.norm1.bias",
                    f"{pre}.norm2.weight", f"{pre}.norm2.bias",
                    f"{pre}.attn.proj.bias", f"{pre}.mlp.fc2.bias")


def plan_specs(model: nn.Module, tp: int = 1, sp: bool = False,
               fsdp_ranks: int = 1, zero1_ranks: int = 1,
               fsdp_min_size: int = FSDP_MIN_SIZE,
               zero1_min_size: int = ZERO1_MIN_SIZE,
               ep_ranks: int = 1) -> Dict[str, ParamSpec]:
    """Every parameter's spec by the rules, from the shapes alone (a model
    on the ``meta`` device will do): TP over ``tp`` model ranks (``sp``:
    the sequence-parallel leaves marked), FSDP over ``fsdp_ranks`` (JAX's
    'data' axis), EP over ``ep_ranks`` (the same axis) and ZeRO-1 over
    ``zero1_ranks`` (its batch axes); 1 turns a leg off."""
    specs = {}
    for name, module, leaf in _owners(model):
        p = module._parameters[leaf]
        specs[name] = ParamSpec(tuple(p.shape),
                                layout_order(_kind(module, leaf), p.dim()))
    if tp > 1:
        layout = _tp_layout(model, specs, tp)
        for prefix, _, _, chunks in layout.linears:
            for leaf in ("weight", "bias"):
                spec = specs.get(f"{prefix}.{leaf}")
                if spec is not None:
                    spec.tp_dim = tp_dim(f"{prefix}.{leaf}", spec.shape, tp)
                    spec.tp_chunks = chunks if spec.tp_dim is not None else 1
        if sp and _sp_on(model, layout):
            for name in _sp_partial_names(layout):
                if name in specs:
                    specs[name].sp_partial = True
    if fsdp_ranks > 1:
        for spec in specs.values():
            spec.fsdp_dim = fsdp_dim(spec, fsdp_ranks, fsdp_min_size)
    if ep_ranks > 1:
        _set_ep(specs, ep_ranks)
    if zero1_ranks > 1:
        for spec in specs.values():
            spec.zero_dim = zero1_dim(spec, zero1_ranks, zero1_min_size)
    return specs


def _apply_tp(model: nn.Module, plan: ShardPlan, sp: bool) -> None:
    """The TP specs into ``plan`` and the modules made parallel."""
    m = plan.mesh
    tp = m.tp
    tp_specs = plan_specs(model, tp, sp)
    for name, spec in tp_specs.items():
        plan.specs[name].tp_dim = spec.tp_dim
        plan.specs[name].tp_chunks = spec.tp_chunks
        plan.specs[name].sp_partial = spec.sp_partial
    layout = _tp_layout(model, tp_specs, tp)
    for _, linear, cls, _ in layout.linears:
        linear.__class__ = cls
        linear.group = m.model_group
        linear.seq = None
    for module in layout.heads:
        module.num_heads //= tp
        if hasattr(module, "tp_group"):
            module.tp, module.tp_group = tp, m.model_group
    for mlp in layout.mlps:
        mlp.drop1.feature_shard = (tp, m.model_rank)
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.sync = (m.data_group, m.data_size)
    if not sp:
        return
    if not _sp_on(model, layout):
        logger.info("dist.sp: the image tower's blocks run on the whole "
                    "token stream (a block is replicated or ToMe is on)")
        return
    seq = SeqParallel(tp, m.model_rank, m.model_group)
    model.image_tower.seq = seq
    for _, block, _ in layout.vit_blocks:
        for lin in (block.attn.qkv, block.attn.proj, block.mlp.fc1,
                    block.mlp.fc2):
            lin.seq = seq
        block.attn.drop.seq = seq
        block.mlp.drop2.seq = seq


# -- FSDP ----------------------------------------------------------------------

class _FsdpAccess:
    """Mixed into a module whose parameters FSDP shards: while the module's
    own forward runs (a remat recompute included), reading such a
    parameter as an attribute gathers it whole (``gather_param``, a
    collective of the gather group, which runs the same forward). Anywhere
    else the attribute is this rank's shard: reading its dtype, or code
    that runs on one rank only, starts no collective."""

    def forward(self, *args, **kwargs):
        live = self.__dict__
        live["_fsdp_live"] = live.get("_fsdp_live", 0) + 1
        try:
            return super().forward(*args, **kwargs)
        finally:
            live["_fsdp_live"] -= 1

    def __getattr__(self, name):
        fsdp = self.__dict__.get("_fsdp")
        if fsdp is not None and name in fsdp and self.__dict__.get("_fsdp_live"):
            return whole_param(self, name)
        return super().__getattr__(name)


_FSDP_CLASSES: Dict[type, type] = {}


def _fsdp_class(cls: type) -> type:
    if issubclass(cls, _FsdpAccess):
        return cls
    if cls not in _FSDP_CLASSES:
        _FSDP_CLASSES[cls] = type(cls.__name__, (_FsdpAccess, cls), {})
    return _FSDP_CLASSES[cls]


class _GatheredLinear(torch.autograd.Function):
    """``x W^T + b`` with W gathered from its FSDP shards in the forward and
    again in the backward (only the shard is kept for it); W's gradient is
    reduce-scattered into the shard."""

    @staticmethod
    def forward(ctx, x, shard, bias, fsdp):
        dim, group, _ = fsdp
        w = gather_dim(shard.detach(), dim, group).to(x.dtype)
        ctx.save_for_backward(x, shard)
        ctx.fsdp = fsdp
        ctx.bias_dtype = None if bias is None else bias.dtype
        return torch.nn.functional.linear(
            x, w, None if bias is None else bias.to(x.dtype))

    @staticmethod
    def backward(ctx, grad):
        x, shard = ctx.saved_tensors
        dim, group, replica = ctx.fsdp
        w = gather_dim(shard.detach(), dim, group).to(grad.dtype)
        gx = grad.matmul(w) if ctx.needs_input_grad[0] else None
        g2 = grad.reshape(-1, grad.shape[-1])
        gw = g2.t().matmul(x.reshape(-1, x.shape[-1])).to(shard.dtype)
        gshard = reduce_scatter_dim(gw, dim, group)
        if replica is not None:
            gshard = _all_reduce_(gshard, replica)
        gb = None if ctx.bias_dtype is None else g2.sum(0).to(ctx.bias_dtype)
        return gx, gshard, gb, None


def gathered_linear(x, shard, bias, fsdp) -> torch.Tensor:
    return _GatheredLinear.apply(x, shard, bias, fsdp)


# -- the plan ----------------------------------------------------------------------

def shard_model(model: nn.Module, mesh: Optional[DataMesh], tp: int = 1,
                sp: bool = False, fsdp: bool = False, zero1: bool = False,
                fsdp_min_size: int = FSDP_MIN_SIZE,
                zero1_min_size: int = ZERO1_MIN_SIZE,
                ep: bool = False) -> nn.Module:
    """Shard ``model`` in place over ``mesh`` (JAX ``derive_state_shardings``
    with ``tp``, ``fsdp``, ``moe_ep=ep``, ``shard_opt_state=zero1``;
    ``sp``: JAX's ``act_sharding``), returning it; a leg already applied is
    kept, so the model builder may apply TP and the runner FSDP, EP and
    ZeRO-1 after it. Without a world (``mesh`` None) or on one data rank
    the data legs hold the whole state, as they do on a JAX axis of size
    1."""
    tp = int(tp) if tp and tp > 1 else 1
    if sp and (mesh is None or mesh.tp <= 1):
        raise ValueError("dist.sp requires dist.tp_size > 1 (the token dim "
                         "shards over the tensor-parallel axis)")
    if mesh is None:
        return model
    if tp != mesh.tp:
        raise ValueError(f"dist.tp_size {tp} does not match the mesh's "
                         f"model groups of {mesh.tp}")
    fsdp = fsdp and mesh.group_ranks > 1
    zero1 = zero1 and mesh.data_size > 1
    ep = ep and mesh.group_ranks > 1
    plan = plan_of(model)
    if plan is None:
        if tp == 1 and not fsdp and not zero1 and not ep:
            return model
        plan = ShardPlan(mesh, plan_specs(model))
    new_tp = tp > 1 and plan.tp == 1
    if new_tp:
        _apply_tp(model, plan, sp)
        plan.tp = tp
    new_fsdp = fsdp and not plan.fsdp
    if new_fsdp:
        for spec in plan.specs.values():
            spec.fsdp_dim = fsdp_dim(spec, mesh.group_ranks, fsdp_min_size)
        plan.fsdp = True
    new_ep = ep and not plan.ep
    if new_ep:
        _set_ep(plan.specs, mesh.group_ranks)
        plan.ep = True
    if zero1 and not plan.zero1:
        for spec in plan.specs.values():
            spec.zero_dim = zero1_dim(spec, mesh.data_size, zero1_min_size)
        plan.zero1 = True
    if new_tp or new_fsdp or new_ep:
        _cut(model, plan, new_tp, new_fsdp, new_ep)
    model.shard_plan = plan
    return model


def _set_ep(specs: Dict[str, ParamSpec], n: int) -> None:
    """The EP rule over ``n`` ranks on top of the specs; an expert leaf it
    splits is no FSDP leaf (JAX's ``ep_shardings`` replaces the base
    sharding of the leaves it matches)."""
    for name, spec in specs.items():
        spec.ep_dim = ep_dim(name, spec.shape, n)
        if spec.ep_dim is not None:
            spec.fsdp_dim = None


def _cut(model: nn.Module, plan: ShardPlan, tp: bool, fsdp: bool,
         ep: bool = False) -> None:
    """Each parameter replaced by this rank's shard (TP's of the whole
    parameter, then FSDP's or EP's of that)."""
    m = plan.mesh
    replica = m.replica_group if m.n_groups > 1 else None
    for name, module, leaf in list(_owners(model)):
        spec = plan.specs[name]
        p = module._parameters[leaf]
        t = p.detach()
        if tp and spec.tp_dim is not None:
            t = plan.local(t, ParamSpec(spec.shape, spec.order, spec.tp_dim,
                                        spec.tp_chunks))
        if fsdp and spec.fsdp_dim is not None:
            t = t.chunk(m.group_ranks, spec.fsdp_dim)[m.rank_in_group]
            fsdp_leaves = module.__dict__.setdefault("_fsdp", {})
            fsdp_leaves[leaf] = (spec.fsdp_dim, m.gather_group, replica)
            module.__class__ = _fsdp_class(type(module))
        if ep and spec.ep_dim is not None:
            t = t.chunk(m.group_ranks, spec.ep_dim)[m.rank_in_group]
            module.ep = (m.gather_group, m.group_ranks)
        if tuple(t.shape) != tuple(p.shape):
            module._parameters[leaf] = nn.Parameter(
                t.contiguous().clone(), requires_grad=p.requires_grad)


# -- state dicts ---------------------------------------------------------------------

def full_state_dict(model: nn.Module,
                    keep: bool = True) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter whole (a
    collective under a shard plan: every rank calls it). With ``keep``
    False, on a rank that does not write the state, each whole tensor is
    dropped as soon as it is gathered, and only the entries no rule shards
    are returned: that rank never holds the whole model."""
    state = model.state_dict()
    plan = plan_of(model)
    if plan is None:
        return state
    out = {}
    for k, v in state.items():
        spec = plan.specs.get(k)
        if spec is not None and (spec.tp_dim is not None
                                 or spec.data_dim is not None):
            v = plan.full(v, spec)
            if not keep:
                continue
        out[k] = v
    return out


def full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The shape of every state-dict entry of the whole model."""
    plan = plan_of(model)
    return {k: (plan.specs[k].shape if plan is not None and k in plan.specs
                else tuple(v.shape))
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor],
                         strict: bool = True):
    """``model.load_state_dict`` of a whole state, each sharded entry cut to
    this rank's shard first."""
    plan = plan_of(model)
    if plan is not None:
        state = {k: plan.local(v, plan.specs[k]) if k in plan.specs else v
                 for k, v in state.items()}
    return model.load_state_dict(state, strict=strict)


# -- gradients ----------------------------------------------------------------------

def reduce_model_gradients(model: nn.Module, mesh: Optional[DataMesh]) -> None:
    """The parameters' gradients summed as JAX's global gradient: the
    sequence-parallel leaves' token-slice parts over the model group, then
    every leaf over the data ranks, except the FSDP leaves, reduce-scattered
    in the backward, and the EP leaves, which already hold every rank's
    tokens (summed over the gather groups' peers only). Under pipeline
    parallelism each leaf's gradient comes from its own stage
    (``reduce_pipeline_gradients``)."""
    if mesh is None:
        return
    if mesh.pp > 1:
        reduce_pipeline_gradients(model, mesh)
        return
    plan = plan_of(model)
    if plan is None:
        reduce_gradients(model.parameters(), mesh.data_group)
        return
    named = dict(model.named_parameters())
    partial = [p for n, p in named.items() if plan.specs[n].sp_partial]
    if partial:
        reduce_gradients(partial, mesh.model_group)
    experts = [p for n, p in named.items() if plan.specs[n].ep_dim is not None]
    if experts and mesh.n_groups > 1:
        reduce_gradients(experts, mesh.replica_group)
    reduce_gradients([p for n, p in named.items()
                      if plan.specs[n].data_dim is None], mesh.data_group)


def reduce_pipeline_gradients(model: nn.Module, mesh: DataMesh) -> None:
    """Every gradient the sum over the data ranks of the one stage that
    computes it (``parallel/pp.param_stages``), on every rank: the other
    stages' parts zeroed, the whole leaves summed over the world and the
    FSDP leaves (reduce-scattered within the stage in the backward) over
    the pipe group. Every rank then holds every gradient."""
    from simseg_tpu_torch.parallel.pp import param_stages

    stages = param_stages(model, mesh.pp)
    plan = plan_of(model)
    whole, fsdp = [], []
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif stages[n] != mesh.stage:
            p.grad.zero_()
        sharded = plan is not None and plan.specs[n].fsdp_dim is not None
        (fsdp if sharded else whole).append(p)
    reduce_gradients(whole, None)
    if fsdp:
        reduce_gradients(fsdp, mesh.pipe_group)


def grad_sq_norm(grads, specs, plan: ShardPlan) -> torch.Tensor:
    """The squared global norm of gradients some of which are shards: each
    rank adds the squares of the shards it owns (``ShardPlan.owns``) and
    the sum runs over the world, so every rank holds the same value."""
    device = next(g.device for g in grads if g is not None)
    sq = torch.zeros((), dtype=torch.float32, device=device)
    for g, spec in zip(grads, specs):
        if g is not None and plan.owns(spec):
            sq = sq + torch.linalg.vector_norm(g.float()) ** 2
    return all_reduce_sum(sq)


def gather_zero_slices(zero, plan: ShardPlan,
                       bucket_bytes: int = _BUCKET_BYTES) -> None:
    """Every ZeRO-1 parameter whole again from the data ranks' updated
    slices (``zero``: (parameter, the view of this rank's slice, spec)), in
    flat buckets of about ``bucket_bytes`` per dtype: one all-gather a
    bucket."""
    m = plan.mesh
    buckets: dict = {}
    for p, o, spec in zero:
        open_ = buckets.setdefault(o.dtype, [[0, []]])
        if open_[-1][0] >= bucket_bytes:
            open_.append([0, []])
        open_[-1][0] += o.numel() * o.element_size()
        open_[-1][1].append((p, o, spec))
    for per_dtype in buckets.values():
        for _, entries in per_dtype:
            flat = torch.cat([o.detach().reshape(-1) for _, o, _ in entries])
            ranks = gather_dim(flat, 0, m.data_group).chunk(m.data_size)
            sizes = [o.numel() for _, o, _ in entries]
            for r, part in enumerate(ranks):
                if r == m.data_rank:
                    continue  # updated in place: ``o`` is a view of ``p``
                for (p, o, spec), x in zip(entries, part.split(sizes)):
                    size = o.shape[spec.zero_dim]
                    p.detach().narrow(spec.zero_dim, r * size, size).copy_(
                        x.view(o.shape))


def state_bytes(model: nn.Module, optimizer=None) -> Tuple[int, int]:
    """(parameter bytes, optimizer-moment bytes) this rank holds."""
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = 0
    if optimizer is not None:
        for st in optimizer.base.state.values():
            for k, v in st.items():
                if torch.is_tensor(v) and k != "step":
                    moments += v.numel() * v.element_size()
    return params, moments
