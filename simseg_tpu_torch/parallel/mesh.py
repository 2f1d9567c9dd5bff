"""Process group set-up and the (replica, data, model) layout (port of
``simseg_tpu/parallel/mesh.py``).

Parity: reference ``simseg/core/initial.py:52-54`` (init_process_group) and
``simseg/utils/dist.py:371-428`` (generate_local_groups). JAX lays the
devices of one program out on a ``Mesh``; the port runs one process per
card (``simseg_tpu_torch/launch.py``) in a ``torch.distributed`` world, and
``DataMesh`` records what the JAX mesh's shape tells its step, with JAX's
order of the axes (``make_mesh``: the model axis innermost):

    rank = (replica * group_ranks + data_in_group) * tp + model

- ``tp`` ranks of one model group (``dist.tp_size``; one data index) hold
  the tensor-parallel shards of one model replica and see the same rows
  (``parallel/tp.py``);
- the ``data_size = world / tp`` data ranks (one model index) split the
  batch: data rank d holds the rows [d B/D, (d + 1) B/D) of the global
  batch, as JAX's batch axes shard it;
- the gather groups of ``loss.group_size``, in data ranks (devices per
  group in JAX, whose batch axes hold no model axis): D / group_size
  groups of contiguous data ranks, JAX's ('replica', 'data') fold.

Every rank builds every group, in the same order, since
``dist.new_group`` is a collective over the world. Host-side collectives
(``parallel/collectives.py``: objects, eval gathers, barriers, the
preemption flag, the model group's batch broadcast) ride gloo groups even
when the world runs NCCL, so they never wait on the card's stream.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_HOST_GROUP = None          # gloo group of the whole world (host collectives)
_MESHES: Dict[Tuple[int, int], "DataMesh"] = {}   # (n_groups, tp) -> mesh


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout: Optional[float] = None) -> bool:
    """Join the ``torch.distributed`` world: one already initialised, or the
    one a launcher describes in the environment (``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Returns True when a
    world is up, False for a single process (none of the five set). ``backend``: NCCL when ``device`` is
    CUDA (None: CUDA, the port's default), gloo on the CPU; a caller may
    choose. On CUDA the rank takes ``cuda:LOCAL_RANK`` unless ``device``
    names a card. ``timeout``: seconds a collective may wait (None: the
    environment's ``SIMSEG_DIST_TIMEOUT``, else torch's default).

    Fails loudly (JAX ``init_distributed``): a half-set environment raises,
    and so does a world that fails to initialise; it never carries on as a
    single process."""
    if dist.is_initialized():
        _join_host_group(None)
        return True
    given = {k: os.environ.get(k) for k in _ENV}
    if not any(given.values()):
        return False
    missing = [k for k, v in given.items() if not v]
    if missing:
        raise ValueError(
            f"torch.distributed environment half set: {', '.join(missing)} "
            f"missing (got {given}); set all of {', '.join(_ENV)} or none")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for and no CUDA device "
                               "is available; pass --device cpu for gloo "
                               "ranks on the CPU")
        torch.cuda.set_device(dev if dev.index is not None
                              else int(given["LOCAL_RANK"]))
    kwargs = {}
    if timeout is None and os.environ.get("SIMSEG_DIST_TIMEOUT"):
        timeout = os.environ["SIMSEG_DIST_TIMEOUT"]
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{given['MASTER_ADDR']}:"
                                 f"{given['MASTER_PORT']}",
            rank=int(given["RANK"]), world_size=int(given["WORLD_SIZE"]),
            **kwargs)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed world requested (WORLD_SIZE="
            f"{given['WORLD_SIZE']}, RANK={given['RANK']}) but "
            f"init_process_group({backend!r}) failed: {e}") from e
    _join_host_group(kwargs.get("timeout"))
    return True


def _join_host_group(timeout) -> None:
    """The gloo group of the host collectives (the world itself under
    gloo), and rank 0 alone logging, as JAX's logger does
    (``simseg_tpu/utils/logger.py:66``); once per process."""
    global _HOST_GROUP
    if _HOST_GROUP is not None:
        return
    if dist.get_backend() == "gloo":
        _HOST_GROUP = dist.group.WORLD
    else:
        _HOST_GROUP = dist.new_group(
            backend="gloo", **({} if timeout is None else {"timeout": timeout}))
    if dist.get_rank() != 0:
        logging.getLogger("simseg_tpu_torch").setLevel(logging.ERROR)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def host_group():
    """The gloo group of the whole world (None without a world)."""
    return _HOST_GROUP if is_distributed() else None


@dataclass(frozen=True)
class DataMesh:
    """The layout of a world: ``world`` ranks, ``tp`` to a model group,
    ``world / tp`` data ranks in ``n_groups`` gather groups. The groups are
    this rank's (None: the world): ``group`` its gather group (None without
    gather groups), ``data_group`` the data ranks of its model index,
    ``replica_group`` the ranks of its (data-in-group, model) position in
    every gather group, ``model_group`` its model group and
    ``model_host_group`` that group over gloo."""
    world: int
    rank: int
    n_groups: int = 1
    group: object = None
    tp: int = 1
    data_group: object = None
    replica_group: object = None
    model_group: object = None
    model_host_group: object = None

    @property
    def data_size(self) -> int:
        return self.world // self.tp

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def group_ranks(self) -> int:
        """Data ranks per gather group (JAX's 'data' axis)."""
        return self.data_size // self.n_groups

    @property
    def rank_in_group(self) -> int:
        return self.data_rank % self.group_ranks

    @property
    def replica(self) -> int:
        return self.data_rank // self.group_ranks

    @property
    def gather_group(self):
        """The group the contrastive loss gathers over: the gather group,
        else every data rank of this model index."""
        return self.group if self.n_groups > 1 else self.data_group


def _new_groups(rank_lists: List[List[int]], rank_: int, **kwargs):
    """Every group of ``rank_lists`` created on every rank, in order;
    returns this rank's."""
    mine = None
    for ranks in rank_lists:
        g = dist.new_group(ranks, **kwargs)
        if rank_ in ranks:
            mine = g
    return mine


def _build_mesh(world: int, rank_: int, n_groups: int, tp: int) -> DataMesh:
    data = world // tp
    gs = data // n_groups

    def at(replica, d, m):
        return (replica * gs + d) * tp + m

    kw = {}
    if tp > 1:
        kw["data_group"] = _new_groups(
            [[d * tp + m for d in range(data)] for m in range(tp)], rank_)
        models = [[d * tp + m for m in range(tp)] for d in range(data)]
        kw["model_group"] = _new_groups(models, rank_)
        kw["model_host_group"] = (
            kw["model_group"] if dist.get_backend() == "gloo"
            else _new_groups(models, rank_, backend="gloo"))
    if n_groups > 1:
        kw["group"] = _new_groups(
            [[at(g, d, m) for d in range(gs)]
             for m in range(tp) for g in range(n_groups)], rank_)
        kw["replica_group"] = _new_groups(
            [[at(g, d, m) for g in range(n_groups)]
             for m in range(tp) for d in range(gs)], rank_)
    return DataMesh(world, rank_, n_groups, tp=tp, **kw)


def make_mesh(group_size: int = -1, tp_size: int = 1) -> Optional[DataMesh]:
    """The world's ``DataMesh``, or None outside a ``torch.distributed``
    world (one process: the global batch is the local batch). ``tp_size``
    ranks form a model group and must divide the world; with ``group_size``
    (devices) in (0, W / tp) the data ranks fold into gather groups, which
    must divide them (JAX ``make_mesh``); otherwise the gather spans the
    data ranks."""
    tp = int(tp_size) if tp_size and tp_size > 1 else 1
    if not is_distributed():
        if tp > 1:
            raise ValueError(f"tp_size {tp} must divide device count 1")
        return None
    world, r = dist.get_world_size(), dist.get_rank()
    if world % tp != 0:
        raise ValueError(f"tp_size {tp} must divide device count {world}")
    n_data = world // tp
    if group_size is None or group_size <= 0 or group_size >= n_data:
        n_groups = 1
    elif n_data % group_size != 0:
        raise ValueError(f"group_size {group_size} must divide data-parallel "
                         f"size {n_data}")
    else:
        n_groups = n_data // group_size
    key = (n_groups, tp)
    if key not in _MESHES:
        _MESHES[key] = _build_mesh(world, r, n_groups, tp)
    return _MESHES[key]


def batch_shards(mesh: Optional[DataMesh]) -> int:
    """Number of ways the batch is split (the data ranks)."""
    return 1 if mesh is None else mesh.data_size
def local_batch_size(global_batch_size: int, mesh: Optional[DataMesh]) -> int:
    n = batch_shards(mesh)
    if global_batch_size % n != 0:
        raise ValueError(f"global batch size {global_batch_size} not "
                         f"divisible by batch shard count {n}")
    return global_batch_size // n


def loss_group_samples(mesh: Optional[DataMesh], batch_size: int) -> int:
    """Samples per gather group, ``batch_size / n_groups``, or -1 (global
    negatives) without groups (JAX ``loss_group_samples``)."""
    n_groups = 1 if mesh is None else mesh.n_groups
    if n_groups <= 1:
        return -1
    if batch_size % n_groups != 0:
        raise ValueError(f"batch_size {batch_size} must divide into "
                         f"{n_groups} device groups")
    return batch_size // n_groups
