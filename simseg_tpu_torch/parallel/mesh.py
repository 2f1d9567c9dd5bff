"""Process group set-up and the data-parallel layout (port of
``simseg_tpu/parallel/mesh.py``).

Parity: reference ``simseg/core/initial.py:52-54`` (init_process_group) and
``simseg/utils/dist.py:371-428`` (generate_local_groups). JAX lays the
devices of one program out on a ``Mesh``; the port runs one process per
card (``simseg_tpu_torch/launch.py``) in a ``torch.distributed`` world, and
``DataMesh`` records what the JAX mesh's shape tells its step:

- the world: W ranks, each holding a contiguous 1/W of the batch (the
  loaders' shards, ``data/datasets.py``), rank r the rows
  [r B/W, (r + 1) B/W) of the global batch, as JAX's 'data' axis shards it;
- the gather groups of ``loss.group_size``, in devices (ranks) as in JAX:
  W / group_size groups of contiguous ranks, JAX's ('replica', 'data')
  fold. Every rank builds every group, in the same order, since
  ``dist.new_group`` is a collective over the world.

Host-side collectives (``parallel/collectives.py``: objects, eval gathers,
barriers, the preemption flag) ride a gloo group even when the world runs
NCCL, so they never wait on the card's stream.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_HOST_GROUP = None          # gloo group of the whole world (host collectives)
_GROUPS: Dict[int, object] = {}   # group_size -> this rank's group


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
    """The data-parallel layout of a world: ``world`` ranks in ``n_groups``
    gather groups of ``group_ranks`` contiguous ranks; ``group`` is this
    rank's group (None: the world)."""
    world: int
    rank: int
    n_groups: int = 1
    group: object = None

    @property
    def group_ranks(self) -> int:
        return self.world // self.n_groups

    @property
    def rank_in_group(self) -> int:
        return self.rank % self.group_ranks


def _group_handles(group_size: int, world: int, rank_: int):
    """This rank's group of ``group_size`` contiguous ranks; every rank
    creates every group, in rank order (``dist.new_group`` is collective)."""
    if group_size not in _GROUPS:
        mine = None
        for start in range(0, world, group_size):
            g = dist.new_group(list(range(start, start + group_size)))
            if start <= rank_ < start + group_size:
                mine = g
        _GROUPS[group_size] = mine
    return _GROUPS[group_size]


def make_mesh(group_size: int = -1) -> Optional[DataMesh]:
    """The world's ``DataMesh``, or None outside a ``torch.distributed``
    world (one process: the global batch is the local batch). With
    ``group_size`` (devices) in (0, W) the world folds into W / group_size
    gather groups, which must divide it (JAX ``make_mesh``); otherwise the
    gather spans the world."""
    if not is_distributed():
        return None
    world, r = dist.get_world_size(), dist.get_rank()
    if group_size is None or group_size <= 0 or group_size >= world:
        return DataMesh(world, r)
    if world % group_size != 0:
        raise ValueError(f"group_size {group_size} must divide data-parallel "
                         f"size {world}")
    return DataMesh(world, r, world // group_size,
                    _group_handles(group_size, world, r))


def batch_shards(mesh: Optional[DataMesh]) -> int:
    """Number of ways the batch is split (the world size)."""
    return 1 if mesh is None else mesh.world


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
