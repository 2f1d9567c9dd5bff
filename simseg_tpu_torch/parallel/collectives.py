"""Collectives over the world or a gather group (port of
``simseg_tpu/parallel/collectives.py``).

Parity: reference ``simseg/utils/dist.py`` — all_gather (:43-62), the
differentiable GatherLayer (:323-354), all_reduce (:77-102), broadcast
(:105-139), barrier (:142-149) and pickled objects (:165-320). JAX runs
these as XLA collectives over mesh axes; here they are ``torch.distributed``
calls over a process group (None: the world).

``all_gather`` is differentiable: its backward sums the gathered gradient
over the group and returns this rank's rows (a reduce-scatter), the
reference's ``gather_backward=True``. ``reduce_gradients`` sums the
parameters' gradients over the world in flat buckets, JAX's psum of the
gradient.

The sharded legs (``parallel/tp.py``, ``parallel/sharding.py``) run on
``gather_dim`` / ``reduce_scatter_dim`` (any dim) and on Megatron's pairs of
differentiable collectives: ``copy_to_group`` (identity, gradient summed)
and ``reduce_from_group`` (sum, gradient passed) around the
tensor-parallel linears, ``gather_seq`` / ``scatter_seq`` (all-gather vs
reduce-scatter, each the other's backward) around them under sequence
parallelism, ``split_dim`` / ``gather_replicated`` where a replicated stream
enters and leaves the sequence-parallel region, and ``gather_param`` (an
FSDP weight gathered, its gradient reduce-scattered).

Gloo and CUDA: gloo's support for CUDA tensors differs from one collective
to another, so every collective of this module whose group runs gloo and
whose tensor lies on a card moves that tensor to the host, runs there and
moves the result back (two ranks sharing one card run gloo, since NCCL
refuses two ranks on a device). ``STAGED_BYTES[0]`` counts the bytes those
copies move, both ways. The computation itself never leaves the card, and
the collective called is the same on both backends
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``), so
the CPU's gloo runs the calls NCCL runs.
"""

from __future__ import annotations

import pickle
from typing import Iterable, List

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from simseg_tpu_torch.parallel.mesh import host_group, is_distributed

STAGED_BYTES = [0]
_BUCKET_BYTES = 25 * 2**20


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    STAGED_BYTES[0] += x.numel() * x.element_size()
    return x.cpu()


def _back(x: torch.Tensor, device) -> torch.Tensor:
    STAGED_BYTES[0] += x.numel() * x.element_size()
    return x.to(device)


def _gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0, in group-rank order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return _back(out, x.device) if staged else out


def _all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group in place (``x`` contiguous)."""
    if _staged(x, group):
        host = _host(x)
        dist.all_reduce(host, op=op, group=group)
        x.copy_(_back(host, x.device))
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    gradient)."""
    if dim == 0:
        return _gather_cat(x, group)
    moved = _gather_cat(x.movedim(dim, 0).contiguous(), group)
    return moved.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``x`` summed over the group, this rank's 1/n slice along ``dim`` kept
    (no gradient; ``x.shape[dim]`` divides by n)."""
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    if staged:
        out = _back(out, x.device)
    return out.movedim(0, dim).contiguous()


def _narrow_rank(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over the group (the
    input of a column-parallel linear)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over the group, its gradient passed as it
    is (the output of a row-parallel linear)."""
    return _ReduceFromGroup.apply(x, group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, ctx.dim, ctx.group), None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _narrow_rank(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _narrow_rank(grad, ctx.dim, ctx.group), None, None


def gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters (the slices'
    consumers each hold a part of the gradient: Megatron-SP's gather
    before a column-parallel linear)."""
    return _GatherSeq.apply(x, dim, group)


def scatter_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter along ``dim``; the backward all-gathers (Megatron-SP's
    reduce-scatter after a row-parallel linear)."""
    return _ScatterSeq.apply(x, dim, group)


def split_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank holds whole;
    the backward all-gathers the slices' gradients."""
    return _SplitDim.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor whose consumers run the same
    on every rank: the backward keeps this rank's slice of the gradient."""
    return _GatherReplicated.apply(x, dim, group)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, replica_group):
        ctx.dim, ctx.group, ctx.replica_group = dim, group, replica_group
        return gather_dim(shard.detach(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        out = reduce_scatter_dim(grad, ctx.dim, ctx.group)
        if ctx.replica_group is not None:
            out = _all_reduce_(out, ctx.replica_group)
        return out, None, None, None


def gather_param(shard: torch.Tensor, dim: int, group,
                 replica_group=None) -> torch.Tensor:
    """An FSDP parameter whole from its shards along ``dim`` over ``group``;
    the backward reduce-scatters the gradient into the shard (then sums it
    over ``replica_group``, the gather groups' peers)."""
    return _GatherParam.apply(shard, dim, group, replica_group)


class _AllGather(torch.autograd.Function):
    """all_gather forward; backward sums the gathered gradient over the
    group and keeps this rank's rows (GatherLayer, dist.py:323-354)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                            ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` of every rank of ``group`` (None: the world) concatenated along
    dim 0 in rank order; differentiable when ``x`` requires grad."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(x, group)
    with torch.no_grad():
        return _gather_cat(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                        group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over the group
    too (each rank's input feeds every rank's sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def all_reduce_sum_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (None: the world), differentiable: the
    synchronised batch statistics of ``models/layers.BatchNorm``."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce_sum(x, group) / dist.get_world_size(group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                        group, dist.ReduceOp.MAX)


def axis_index(group=None) -> int:
    """This rank's position in ``group`` (the reference's group rank)."""
    return dist.get_rank(group)


def reduce_gradients(params: Iterable[torch.nn.Parameter], group=None,
                     bucket_bytes: int = _BUCKET_BYTES) -> None:
    """Sums every parameter's ``.grad`` over ``group`` (None: the world) in
    place, in flat buckets of about ``bucket_bytes`` per dtype and device.
    A parameter without a gradient has none on every rank (the ranks run
    one program) and is left out."""
    buckets: dict = {}      # (dtype, device) -> [[grads], ...], the last open
    for p in params:
        if p.grad is None:
            continue
        open_ = buckets.setdefault((p.grad.dtype, p.grad.device), [[0, []]])
        if open_[-1][0] >= bucket_bytes:
            open_.append([0, []])
        open_[-1][0] += p.grad.numel() * p.grad.element_size()
        open_[-1][1].append(p.grad)
    for per_key in buckets.values():
        for _, grads in per_key:
            flat = _all_reduce_(_flatten_dense_tensors(grads), group)
            for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(reduced)


# -- host side ---------------------------------------------------------------

def broadcast_batch(batch: dict, src: int, group) -> dict:
    """The host tensors of ``batch`` as the group's rank ``src`` (a global
    rank) holds them, on every rank of ``group``: the ranks of a model
    group load the same shard, and this makes their random augmentations
    one draw."""
    out = {}
    for k in sorted(batch):
        t = batch[k].contiguous().clone()
        dist.broadcast(t, src, group=group)
        out[k] = t
    return out


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank, pickled (JAX
    ``broadcast_object``; dist.py broadcast_object_list); without a world,
    ``obj``."""
    if not is_distributed():
        return obj
    group = host_group()
    is_src = dist.get_rank() == src
    payload = pickle.dumps(obj) if is_src else b""
    size = torch.tensor([len(payload)], dtype=torch.int64)
    dist.broadcast(size, src, group=group)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if is_src
           else torch.empty(int(size), dtype=torch.uint8))
    dist.broadcast(buf, src, group=group)
    return obj if is_src else pickle.loads(buf.numpy().tobytes())


def barrier() -> None:
    """Every rank waits here for the others (dist.py:142-149)."""
    if is_distributed():
        dist.barrier(group=host_group())


def process_allgather(x) -> np.ndarray:
    """(W, *x.shape): every rank's host array ``x`` (equal shapes), in rank
    order; (1, *x.shape) without a world. float64 and int64 travel as they
    are, bit for bit (JAX moves them as uint32 pairs)."""
    x = np.ascontiguousarray(np.asarray(x))
    if not is_distributed():
        return x[None]
    t = torch.from_numpy(x.copy())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t, group=host_group())
    return torch.stack(parts).numpy()


def allgather_rows(arrays: List[np.ndarray], fills: List) -> List[np.ndarray]:
    """Every rank's rows of each array in ``arrays`` (one leading length n
    per rank, which may differ, 0 included), concatenated in rank order:
    each rank pads to the longest shard with its array's fill value and the
    padding stays in (the caller drops it by its fill, as the eval gathers
    drop id -1; JAX ``tools/retrieval_evaluation.py:125-146``)."""
    n = arrays[0].shape[0]
    n_max = int(process_allgather(np.asarray([n], np.int64)).max())
    out = []
    for a, fill in zip(arrays, fills):
        pad = np.full((n_max - n,) + a.shape[1:], fill, a.dtype)
        g = process_allgather(np.concatenate([a, pad]))
        out.append(g.reshape((-1,) + a.shape[1:]))
    return out
