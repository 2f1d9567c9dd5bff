"""Global execution context singleton (port of
``simseg_tpu/utils/context.py``).

Parity: reference ``simseg/utils/context.py:13-119`` — the ENV singleton
carrying rank / size / local device info, the active config and its
snapshot, plus ``root_only`` / ``local_root_only`` decorators gating
host-side work to rank 0 / each node's local rank 0. The identity comes
from ``torch.distributed`` (rank and world size of the default group, 0
and 1 without one) and ``LOCAL_RANK``; ``devices`` are the node's CUDA
devices and ``device`` the one this rank drives (``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, List

import torch


class _Singleton(type):
    _instances: dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class GlobalContext(metaclass=_Singleton):
    def __init__(self) -> None:
        self.cfg: Any = None
        self.cfg_snapshot: Any = None
        self.mesh: Any = None
        self.dist_mode: str = "torch"

    # -- process identity -------------------------------------------------------
    @property
    def rank(self) -> int:
        dist = _dist()
        return dist.get_rank() if dist is not None else 0

    @property
    def size(self) -> int:
        dist = _dist()
        return dist.get_world_size() if dist is not None else 1

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK", "0") or 0)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def devices(self) -> List[torch.device]:
        """The node's CUDA devices (none without CUDA)."""
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    @property
    def device(self) -> torch.device:
        """The card this rank drives, ``cuda:LOCAL_RANK``."""
        return torch.device("cuda", self.local_rank)

    @property
    def device_count(self) -> int:
        return len(self.devices)


ENV = GlobalContext()


def root_only(fn: Callable) -> Callable:
    """Run only on rank 0 (parity: context.py root_only)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if ENV.is_root:
            return fn(*args, **kwargs)
        return None

    return wrapper


def local_root_only(fn: Callable) -> Callable:
    """Run only on each node's local rank 0 (parity: context.py
    local_root_only): per-node work such as a local cache directory."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if ENV.local_rank == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper
