"""Tensor and sequence parallelism: the sharding rules and the parallel
linears (port of ``simseg_tpu/parallel/tp.py`` and of the sequence-sharded
residual stream of ``simseg_tpu/models/vit.py:341-349``).

JAX annotates the parameters with a 'model' mesh-axis sharding and lets
GSPMD insert the collectives. The port carries the same rules (``tp_dim``:
JAX's ``_TP_RULES`` / ``_leaf_spec`` under the port's module names, in
PyTorch's (out, in) weight layout, the transpose of flax's (in, out)
kernel) and runs Megatron's layers with explicit collectives
(``parallel/collectives.py``):

- column-parallel (timm's ``blocks.N.attn.qkv`` and ``mlp.fc1``, HF BERT's
  ``attention.self.{query,key,value}`` and ``intermediate.dense``): the
  weight's output rows and the bias sharded; the input passes as it is and
  its gradient is summed over the model group (``copy_to_group``);
- row-parallel (``attn.proj``, ``mlp.fc2``, ``attention.output.dense``,
  ``output.dense``): the weight's input columns sharded, the bias
  replicated and added after the partial products are summed over the
  model group (``reduce_from_group``).

JAX shards the fused qkv kernel contiguously over its output dim, which
GSPMD may split mid-head; explicit collectives need each rank's q, k and v
for its own heads, so the port shards each third of it by heads
(``tp_chunks`` 3) and holds the result, not the layout, against JAX. A
block (an attention or an MLP) whose heads or hidden units do not divide
by the model group stays replicated as a whole, as JAX leaves an
indivisible leaf replicated (``tp.py:56-71``).

Sequence parallelism (``dist.sp``, Megatron-SP; ``SeqParallel``): between
the image tower's blocks each model rank holds a slice of the tokens
(padded to a multiple of tp, the pad rows dropped after every gather, so
they reach neither the attention, nor LoDA's top-k, nor the loss). The
stream is all-gathered before the column linears and reduce-scattered
after the row linears; the LayerNorms and the row linears' biases then see
a slice of the tokens, and their gradients are summed over the model
group (``ParamSpec.sp_partial``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import Linear
from simseg_tpu_torch.parallel.collectives import (copy_to_group, gather_replicated,
                                                   gather_seq, reduce_from_group,
                                                   scatter_seq, split_dim)

_COL = "col"   # weight (out, in): shard out; bias (out,): shard
_ROW = "row"   # weight (out, in): shard in;  bias (out,): replicate

_IMG = r"^image_encoder\.model\.model\."
_TXT = r"^text_encoder\.model\.model\.encoder\."
_TP_RULES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat), role)
    for pat, role in [
        # ViT blocks (models/vit.py): fused qkv + out proj + MLP
        (_IMG + r"blocks\.\d+\.attn\.qkv\.", _COL),
        (_IMG + r"blocks\.\d+\.attn\.proj\.", _ROW),
        (_IMG + r"blocks\.\d+\.mlp\.fc1\.", _COL),
        (_IMG + r"blocks\.\d+\.mlp\.fc2\.", _ROW),
        # BERT layers (models/bert.py): separate q/k/v + output + MLP
        (_TXT + r"layer\.\d+\.attention\.self\.(query|key|value)\.", _COL),
        (_TXT + r"layer\.\d+\.attention\.output\.dense\.", _ROW),
        (_TXT + r"layer\.\d+\.intermediate\.dense\.", _COL),
        (_TXT + r"layer\.\d+\.output\.dense\.", _ROW),
    ]
)


def tp_dim(name: str, shape, tp: int) -> Optional[int]:
    """The dim of the port's parameter ``name`` (of the whole ``shape``)
    that tensor parallelism over ``tp`` ranks shards, or None (replicated):
    JAX's ``_leaf_spec`` in PyTorch's layout."""
    for pat, role in _TP_RULES:
        if pat.search(name):
            break
    else:
        return None
    if not shape:
        return None
    if name.endswith(".bias"):
        return 0 if role == _COL and shape[0] % tp == 0 else None
    if len(shape) != 2:
        return None
    if role == _COL:
        return 0 if shape[0] % tp == 0 else None
    return 1 if shape[1] % tp == 0 else None


_EP_LEAF = re.compile(r"\.moe\.(w1|w2|b1|b2)$")


def ep_dim(name: str, shape, n: int) -> Optional[int]:
    """JAX ``ep_shardings`` (``simseg_tpu/parallel/tp.py:97-124``): an MoE
    layer's expert weights (``…moe.w1`` / ``b1`` / ``w2`` / ``b2``, leading
    dim the experts) are split over the data axis (``n`` ranks) when the
    expert count divides it, else they stay replicated."""
    if _EP_LEAF.search(name) and shape and shape[0] % n == 0:
        return 0
    return None


def _largest_free_dim(spec: "ParamSpec", n: int, taken=()) -> Optional[int]:
    """The largest dim of the whole shape not in ``taken`` that ``n``
    divides, ties in the JAX layout's order (its stable sort)."""
    for d in sorted(spec.order, key=lambda d: -spec.shape[d]):
        if d not in taken and spec.shape[d] % n == 0:
            return d
    return None


def _numel(shape) -> int:
    total = 1
    for s in shape:
        total *= s
    return total


def fsdp_dim(spec: "ParamSpec", n: int, min_size: int = 2**14) -> Optional[int]:
    """JAX ``fsdp_shardings``: a parameter of at least ``min_size`` elements
    is sharded over the data axis (``n`` ranks) on its largest still
    unsharded dim that ``n`` divides."""
    if not spec.shape or _numel(spec.shape) < min_size:
        return None
    return _largest_free_dim(spec, n, (spec.tp_dim,))


def zero1_dim(spec: "ParamSpec", n: int, min_size: int = 2**16) -> Optional[int]:
    """JAX ``opt_state_sharding`` applied where ``derive_state_shardings``
    applies it: the moments of a parameter that the TP and FSDP rules left
    replicated, of at least ``min_size`` elements, are sharded over the
    batch axes (``n`` data ranks) on the largest dim that ``n`` divides."""
    if spec.tp_dim is not None or spec.data_dim is not None:
        return None
    if not spec.shape or _numel(spec.shape) < min_size:
        return None
    return _largest_free_dim(spec, n)


def layout_order(kind: str, ndim: int) -> Tuple[int, ...]:
    """PyTorch's dims in the order of the JAX layout's: a linear weight
    (out, in) is flax's (in, out) kernel, a conv weight (O, I, kh, kw) its
    (kh, kw, I, O); everything else keeps its order."""
    if kind == "linear" and ndim == 2:
        return (1, 0)
    if kind == "conv" and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


@dataclass
class ParamSpec:
    """Where one parameter lives. ``shape``: the whole parameter;
    ``order``: ``layout_order``; ``tp_dim`` (and ``tp_chunks`` equal parts
    of it sharded each: 3 for the fused qkv) over the model group;
    ``fsdp_dim`` over the data ranks of a gather group (JAX's 'data'
    axis); ``ep_dim``: an MoE layer's expert dim over the same ranks, used
    as it is (expert parallelism); ``zero_dim``: the optimizer moments' dim
    over the data ranks (the parameter itself whole); ``sp_partial``: its
    gradient is a sum over the model group's token slices."""
    shape: Tuple[int, ...]
    order: Tuple[int, ...]
    tp_dim: Optional[int] = None
    tp_chunks: int = 1
    fsdp_dim: Optional[int] = None
    zero_dim: Optional[int] = None
    sp_partial: bool = False
    ep_dim: Optional[int] = None

    @property
    def data_dim(self) -> Optional[int]:
        """The dim split over the data ranks of a gather group (FSDP's or
        EP's), else None."""
        return self.fsdp_dim if self.fsdp_dim is not None else self.ep_dim

    def flax_spec(self, zero_axis="data") -> Tuple:
        """The JAX PartitionSpec of the parameter (or, with ZeRO-1, of its
        moments) in the flax layout's dims: 'model', 'data', ``zero_axis``
        or None per dim."""
        out = []
        for d in self.order:
            out.append("model" if d == self.tp_dim else
                       "data" if d == self.data_dim else
                       zero_axis if d == self.zero_dim else None)
        return tuple(out)


class SeqParallel:
    """The image tower's residual stream sliced by tokens over a model group
    (``dist.sp``): ``enter`` pads the tokens to a multiple of tp and keeps
    this rank's slice, ``gather`` / ``scatter`` wrap the column / row
    linears, ``leave`` gathers the stream whole after the last block.
    ``tokens`` is the current forward's token count."""

    def __init__(self, tp: int, rank: int, group) -> None:
        self.tp, self.rank, self.group = tp, rank, group
        self.tokens = 0

    @property
    def padded(self) -> int:
        return -(-self.tokens // self.tp) * self.tp

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padded - self.tokens
        return F.pad(x, (0, 0, 0, pad)) if pad else x

    def rows(self) -> Tuple[int, int]:
        """(first padded row, rows) of this rank's slice."""
        n = self.padded // self.tp
        return self.rank * n, n

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        self.tokens = x.shape[1]
        return split_dim(self._pad(x), 1, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return gather_replicated(x, 1, self.group)[:, :self.tokens]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_seq(x, 1, self.group)[:, :self.tokens]

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        return scatter_seq(self._pad(y), 1, self.group)


class ColumnParallelLinear(Linear):
    """A ``Linear`` holding its model rank's output rows (``group``: the
    model group; ``seq``: the ``SeqParallel`` of a sequence-parallel tower,
    else None)."""
    group = None
    seq: Optional[SeqParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.seq.gather(x) if self.seq is not None else copy_to_group(
            x, self.group)
        return self.product(x, self.bias)


class RowParallelLinear(Linear):
    """A ``Linear`` holding its model rank's input columns; the partial
    products are summed over the model group (reduce-scattered by tokens
    under sequence parallelism), then the replicated bias is added."""
    group = None
    seq: Optional[SeqParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x, None)
        y = self.seq.scatter(y) if self.seq is not None else reduce_from_group(
            y, self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)
