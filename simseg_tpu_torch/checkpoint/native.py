"""Native checkpoint save/restore with step metadata and auto-resume (port
of ``simseg_tpu/checkpoint/native.py``: the msgpack backend, and the orbax
backend on ``torch.distributed.checkpoint``).

Parity: reference ``simseg/core/hooks/checkpoint.py`` — step checkpoints
every ``ckpt.step_interval`` (:90-95), per-epoch checkpoints (:97-108),
auto-resume restoring model/optimizer/epoch/step/inner_step (:142-182),
plus a config snapshot dump (:69-77).

Format: a directory per checkpoint holding ``train_state.pt`` (``torch.save``
of the model's and the optimizer's state dicts and the step) and a
``meta.json`` (time, versions, epoch/step/inner_step). The same crash
discipline as the JAX version: files go through a temp file and an atomic
rename, the ``latest_ckpt`` pointer flips only once a checkpoint is
complete, and a re-save under an existing name writes a fresh
``name@<step>`` directory and prunes the superseded ones.

In a ``torch.distributed`` world rank 0 writes (JAX
``checkpoint/native.py:31-36``), and every rank waits at a barrier until
the files are complete, so a rank that resumes, or reads the pointer, reads
the same checkpoint. On a sharded leg (``parallel/sharding.py``) every rank
takes part in gathering the shards, tensor by tensor, and only rank 0 keeps
them: the parameters and the optimizer's moments are written whole, the
file a data-parallel run writes, and a load cuts them to whatever leg the
loading run has.

The orbax backend (``ckpt.backend: orbax``; JAX ``make_orbax_manager``,
``save_checkpoint_orbax``, ``load_checkpoint_orbax`` and the params-only
read of ``load_params``, :138-267) is built on ``torch.distributed.
checkpoint`` (``async_save``, ``load``, its file-system writer and reader)
with orbax's rules:

- one directory per step, named by the step's number: ``<dir>/<step>/``
  holds ``rank_<r>/`` (each rank's DCP checkpoint: ``.metadata`` and its
  ``.distcp`` file) and ``meta.json`` (epoch, step, inner_step, wandb_id),
  which rank 0 writes last, once every rank's write has ended: a step
  without it is incomplete and never taken as the latest;
- ``max_to_keep`` (3) complete steps: when a step completes, the oldest
  beyond that are deleted;
- async saves: the blocking part is the device-to-host snapshot (a copy of
  every tensor this rank writes), so no later in-place update reaches a
  checkpoint being written; the write then drains in the background and
  ``wait_until_finished`` joins it; a save first joins the one before;
- a save at a step that exists waits for any write in flight, deletes the
  step and writes it again: the later meta wins (an epoch-end save and an
  interval save can land on one step);
- a write that fails on one rank fails on every rank: each ends its write
  with the same two barriers whether or not its own part failed, and then
  finds a rank's marker of its written part missing; every rank's
  ``wait_until_finished`` raises, and the step stays incomplete;
- a restore waits for any save in flight and takes the latest complete
  step, or the one asked for;
- no gather: each rank writes only the parts it holds (its TP or FSDP
  shard, its ZeRO-1 slice of the moments), each part once over the world
  (``ShardPlan.owns``; rank 0 the tensors every rank holds whole), as
  boxes of the whole tensor, keyed ``model/<name>@<offsets>``
  (``ShardPlan.index``), and each rank restores only its own; a run of
  another leg or world assembles what it needs from the boxes. One process
  reads a multi-rank directory's parameters whole (``load_params``).

The port reads the step directories it writes; it does not read orbax
directories written by JAX, as its msgpack backend does not read JAX's
msgpack files.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import pickle
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from simseg_tpu_torch.parallel.collectives import barrier
from simseg_tpu_torch.parallel.mesh import is_distributed, rank, world_size
from simseg_tpu_torch.parallel.sharding import (full_state_dict,
                                                load_full_state_dict, plan_of)

logger = logging.getLogger(__name__)

STATE_FILE = "train_state.pt"
META_FILE = "meta.json"
LATEST = "latest_ckpt"


def save_checkpoint(directory: str, name: str, model: torch.nn.Module,
                    optimizer=None, meta: Optional[Dict[str, Any]] = None,
                    make_latest: bool = True) -> Optional[str]:
    """Write ``model`` (and ``optimizer``) under ``directory/name``; returns
    the path, None on a rank other than 0 (JAX ``save_checkpoint``). Every
    rank of a world must call it: the shards are gathered over the ranks,
    and the write ends at a barrier."""
    writer = rank() == 0
    state = {"model": full_state_dict(model, keep=writer),
             "step": (meta or {}).get("step", 0)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict(keep=writer)
    path = _write_checkpoint(directory, name, state, meta,
                             make_latest) if writer else None
    barrier()
    return path


def _write_checkpoint(directory, name, state, meta, make_latest):
    base = name
    path = os.path.join(directory, name)
    meta = dict(meta or {})
    if make_latest and os.path.exists(os.path.join(path, STATE_FILE)):
        name = f"{name}@{meta.get('step', int(time.time() * 1000))}"
        path = os.path.join(directory, name)
        if os.path.exists(os.path.join(path, STATE_FILE)):
            # the same step saved again: a timestamp keeps the name fresh
            name = f"{base}@{int(time.time() * 1000)}"
            path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)

    meta.setdefault("time", time.strftime("%Y-%m-%d %H:%M:%S"))
    meta.setdefault("simseg_tpu_torch_version", _version())
    meta.setdefault("torch_version", torch.__version__)

    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    tmp_meta = os.path.join(path, META_FILE + ".tmp")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp_meta, os.path.join(path, META_FILE))

    if make_latest:
        link = os.path.join(directory, LATEST)
        with open(link + ".tmp", "w") as f:
            f.write(name)
        os.replace(link + ".tmp", link)
        _prune_versions(directory, base, keep=name)
    logger.info("Saved checkpoint %s", path)
    return path


def _prune_versions(directory: str, base: str, keep: str) -> None:
    """Remove superseded ``base`` / ``base@*`` directories once the pointer
    has flipped to ``keep``."""
    for entry in os.listdir(directory):
        if entry == keep or not (entry == base or entry.startswith(base + "@")):
            continue
        shutil.rmtree(os.path.join(directory, entry), ignore_errors=True)


def _resolve(directory: str, name: Optional[str]) -> str:
    if name is None:
        with open(os.path.join(directory, LATEST)) as f:
            name = f.read().strip()
    return os.path.join(directory, name)


def load_checkpoint(directory: str, model: torch.nn.Module, optimizer=None,
                    name: Optional[str] = None) -> Dict[str, Any]:
    """Restore ``model`` (and ``optimizer``) in place from
    ``directory/name``, following ``latest_ckpt`` when name is None;
    returns the meta (JAX ``load_checkpoint``)."""
    path = _resolve(directory, name)
    device = next(model.parameters()).device
    state = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                       weights_only=True)
    load_full_state_dict(model, state["model"], strict=True)
    if optimizer is not None and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    logger.info("Loaded checkpoint %s (epoch=%s, step=%s)", path,
                meta.get("epoch"), meta.get("step"))
    return meta


def load_params(path: str, model: torch.nn.Module) -> None:
    """Only the model's parameters from a checkpoint directory, from a
    ``ckpt.dir``-style parent through its ``latest_ckpt`` pointer, or from
    an orbax-backend directory (numeric step directories and no pointer:
    its latest complete step, read whole in one process). External
    pretrained init and export: no optimizer state, no step."""
    if (os.path.isdir(path)
            and not os.path.exists(os.path.join(path, STATE_FILE))
            and not os.path.exists(os.path.join(path, LATEST))
            and looks_like_orbax_dir(path)):
        load_params_orbax(path, model)
        return
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        path = _resolve(path, None)
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=next(model.parameters()).device,
                       weights_only=True)
    load_full_state_dict(model, state["model"], strict=True)


def has_checkpoint(directory: str) -> bool:
    link = os.path.join(directory, LATEST)
    if not os.path.exists(link):
        return False
    with open(link) as f:
        name = f.read().strip()
    return os.path.exists(os.path.join(directory, name, STATE_FILE))


# -- the orbax backend on torch.distributed.checkpoint -----------------------------

ORBAX_META = "meta.json"
_RANK_DIR = "rank_{}"
_WRITTEN = "written"    # in a rank's directory once its part is on disk
_OBJECTS = "objects"
# threads (and files) of each rank's write: one thread leaves most of the
# host's write rate unused
WRITE_THREADS = 4


def looks_like_orbax_dir(path: str) -> bool:
    """A directory of numeric step directories (JAX ``_looks_like_orbax_dir``)."""
    return any(name.isdigit() for name in os.listdir(path))


def complete_steps(directory: str) -> List[int]:
    """The steps under ``directory`` whose write ended (``meta.json``
    there), in order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit()
                  and os.path.exists(os.path.join(directory, n, ORBAX_META)))


class CheckpointManager:
    """orbax's ``CheckpointManager`` (JAX ``make_orbax_manager``) over
    ``torch.distributed.checkpoint``: step directories, ``max_to_keep``,
    async saves joined by ``wait_until_finished``. In a world every rank
    makes it at once (a gloo group of its own carries, from the background
    thread, the two barriers that end each write). ``last_snapshot_s`` and
    ``last_write_s`` time the last save's blocking snapshot and its
    background write."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._group = None
        if is_distributed():
            import torch.distributed as dist

            self._group = dist.new_group(backend="gloo")
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_snapshot_s = self.last_write_s = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return complete_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _barrier(self) -> None:
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def _synced(self, done: Callable[[], bool], what: str
                ) -> Optional[BaseException]:
        """Passes the barrier, then what went wrong if ``done()`` is false."""
        try:
            self._barrier()
            return None if done() else RuntimeError(what)
        except Exception as e:
            return e

    def _written(self, step: int, r: int) -> str:
        return os.path.join(self.step_dir(step), _RANK_DIR.format(r), _WRITTEN)

    def wait_until_finished(self) -> None:
        """Joins the write in flight; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an async checkpoint write failed") from err

    def delete(self, step: int) -> None:
        """Deletes ``step``'s directory (complete or not), every rank
        calling it."""
        self.wait_until_finished()
        if rank() == 0:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)
        self._barrier()

    def save(self, step: int, items: Dict[str, Any], meta: Dict[str, Any]) -> None:
        """Snapshots ``items`` (this rank's key -> tensor or object) to the
        host, then writes them under ``<step>/rank_<r>`` in the background;
        once every rank's write has ended rank 0 writes ``meta`` and drops
        the steps past ``max_to_keep``."""
        import torch.distributed.checkpoint as dcp

        self.wait_until_finished()
        exists = os.path.exists(self.step_dir(step))
        self._barrier()   # every rank has looked before any rank writes there
        if exists:
            self.delete(step)
        t0 = time.perf_counter()
        snapshot = {k: _snapshot(v) for k, v in items.items()}
        t1 = time.perf_counter()
        self.last_snapshot_s = t1 - t0
        out = os.path.join(self.step_dir(step), _RANK_DIR.format(rank()))
        os.makedirs(out, exist_ok=True)
        future = dcp.async_save(snapshot, storage_writer=dcp.FileSystemWriter(
                                    out, thread_count=WRITE_THREADS),
                                process_group=self._group, no_dist=True)
        self._thread = threading.Thread(target=self._finish,
                                        args=(future, step, dict(meta), t1),
                                        daemon=True)
        self._thread.start()

    def _finish(self, future, step: int, meta: Dict[str, Any], t0: float) -> None:
        """Every rank passes the same two barriers whether or not its own
        part failed, and after each reads the same files: each rank's
        marker of its written part, then ``meta.json``. So a failure on
        any rank is raised by every rank's ``wait_until_finished``, and
        the step stays incomplete."""
        error = _error_of(future.result)
        if error is None:
            error = _error_of(lambda: open(self._written(step, rank()), "w").close())
        synced = self._synced(
            lambda: all(os.path.exists(self._written(step, r))
                        for r in range(world_size())),
            f"another rank's write of step {step} failed")
        error = error or synced
        if error is None and rank() == 0:
            error = _error_of(lambda: self._complete(step, meta))
        synced = self._synced(
            lambda: os.path.exists(os.path.join(self.step_dir(step), ORBAX_META)),
            f"rank 0 did not complete step {step}")
        error = error or synced
        if error is None:
            self.last_write_s = time.perf_counter() - t0
        self._error = error   # re-raised by wait_until_finished

    def _complete(self, step: int, meta: Dict[str, Any]) -> None:
        """Rank 0, once every rank's part is on disk: ``meta`` marks the
        step complete, then the steps past ``max_to_keep`` go."""
        path = os.path.join(self.step_dir(step), ORBAX_META)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(path + ".tmp", path)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
        logger.info("Saved checkpoint %s", self.step_dir(step))


def _error_of(fn: Callable[[], Any]) -> Optional[BaseException]:
    try:
        fn()
    except Exception as e:
        return e
    return None


def _snapshot(value):
    """A host copy of a tensor (the blocking part of an async save), or an
    object pickled to bytes (a leaf DCP stores as it is)."""
    if torch.is_tensor(value):
        return value.detach().to("cpu", copy=True)
    return pickle.dumps(value)


def make_orbax_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def _boxes(index):
    """(local slices, whole offsets) of each box of a part: the part's
    positions along each dim split into runs of consecutive whole indices,
    one box per run of every dim."""
    per_dim = []
    for ix in index:
        cut = np.flatnonzero(np.diff(ix) != 1) + 1
        starts, ends = np.r_[0, cut], np.r_[cut, len(ix)]
        per_dim.append([(slice(int(a), int(b)), int(ix[a]))
                        for a, b in zip(starts, ends)])
    return [(tuple(sl for sl, _ in box), tuple(o for _, o in box))
            for box in itertools.product(*per_dim)]


def _box_key(key: str, offsets) -> str:
    return f"{key}@{','.join(str(o) for o in offsets)}"


def _put(items: Dict[str, Any], key: str, value: torch.Tensor, index) -> None:
    """``value`` (this rank's part, at ``index`` in the whole; None: the
    whole tensor) into ``items`` under its key or its boxes' keys."""
    if index is None:
        items[key] = value
        return
    for sl, off in _boxes(index):
        items[_box_key(key, off)] = value[sl]


def _sharded(spec) -> bool:
    return spec is not None and (spec.tp_dim is not None
                                 or spec.data_dim is not None)


def orbax_items(model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
    """What this rank writes of ``model`` and ``optimizer``: each part it
    counts (``ShardPlan.owns``; a ZeRO-1 moment slice on each data rank),
    the tensors every rank holds whole on rank 0 only, and on rank 0 the
    optimizer's objects (groups, counters, non-tensor state)."""
    plan = plan_of(model)
    writer = rank() == 0
    items: Dict[str, Any] = {}
    for k, v in model.state_dict().items():
        spec = None if plan is None else plan.specs.get(k)
        if _sharded(spec):
            if plan.owns(spec):
                _put(items, f"model/{k}", v, plan.index(spec))
        elif writer:
            items[f"model/{k}"] = v
    if optimizer is None:
        return items
    objects: Dict[str, Any] = {}
    base = optimizer.base
    for name, t, spec, zero in optimizer.base_entries():
        for k, v in base.state.get(t, {}).items():
            key = f"optim/{name}/{k}"
            if not torch.is_tensor(v):
                objects.setdefault(name, {})[k] = v
            elif v.dim() > 0 and (zero or _sharded(spec)):
                if optimizer.owns(spec, zero):
                    _put(items, key, v, plan.index(spec, zero))
            elif writer:
                items[key] = v
    if optimizer.acc is not None:
        for name, a, spec in zip(optimizer.names, optimizer.acc, optimizer.specs):
            if _sharded(spec):
                if plan.owns(spec):
                    _put(items, f"optim.acc/{name}", a, plan.index(spec))
            elif writer:
                items[f"optim.acc/{name}"] = a
    if writer:
        items[_OBJECTS] = {
            "param_groups": base.state_dict()["param_groups"],
            "state": objects, "notfinite_count": optimizer.notfinite_count,
            "mini_step": optimizer.mini_step,
            "acc": optimizer.acc is not None}
    return items


class _Reader:
    """The tensors of one step directory by key, over every rank's DCP
    checkpoint: ``fill`` plans a target's read (its own boxes where the
    directory holds them, else the whole tensor assembled from every box),
    ``run`` reads what was planned, one ``dcp.load`` a rank directory."""

    def __init__(self, step_dir: str) -> None:
        import torch.distributed.checkpoint as dcp

        self.where: Dict[str, str] = {}
        self.meta: Dict[str, Any] = {}
        self.boxes: Dict[str, list] = {}
        for n in sorted(os.listdir(step_dir)):
            if not n.startswith("rank_"):
                continue
            path = os.path.join(step_dir, n)
            md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
            for key, m in md.items():
                self.where[key] = path
                self.meta[key] = m
                base, _, off = key.partition("@")
                if off:
                    self.boxes.setdefault(base, []).append(
                        (tuple(int(o) for o in off.split(",")), tuple(m.size)))
        self._reads: Dict[str, Dict[str, Any]] = {}
        self._after: list = []

    def __contains__(self, key: str) -> bool:
        return key in self.where or key in self.boxes

    def dtype(self, key: str) -> torch.dtype:
        if key in self.meta:
            return self.meta[key].properties.dtype
        first = _box_key(key, self.boxes[key][0][0])
        return self.meta[first].properties.dtype

    def _read(self, key: str, shape) -> torch.Tensor:
        buf = torch.empty(shape, dtype=self.meta[key].properties.dtype)
        self._reads.setdefault(self.where[key], {})[key] = buf
        return buf

    def obj(self, key: str):
        """Plans an object's read; the returned holder's ``value`` is set
        by ``run``."""
        holder = {}
        self._reads.setdefault(self.where[key], {})[key] = None
        self._after.append(lambda r, k=key: holder.__setitem__(
            "value", pickle.loads(r[k])))
        return holder

    def fill(self, key: str, target: torch.Tensor, index=None,
             whole_shape=None) -> None:
        """Plans ``target`` (this rank's part at ``index`` of the whole, or
        with ``index`` None the whole) read from ``key``."""
        if key in self.where:                       # written whole
            buf = self._read(key, tuple(self.meta[key].size))
            sl = None if index is None else np.ix_(*index)
            self._after.append(lambda r: target.copy_(
                buf if sl is None else buf[sl]))
            return
        shape = whole_shape if index is None else None
        own = _boxes(index if index is not None else
                     [np.arange(n) for n in shape])
        if all(_box_key(key, off) in self.where
               and tuple(self.meta[_box_key(key, off)].size)
               == tuple(x.stop - x.start for x in sl) for sl, off in own):
            for sl, off in own:
                k = _box_key(key, off)
                buf = self._read(k, tuple(self.meta[k].size))
                self._after.append(lambda r, sl=sl, buf=buf:
                                   target[sl].copy_(buf))
            return
        # another leg's boxes: the whole tensor, then this rank's part
        parts = []
        for off, size in self.boxes[key]:
            parts.append((off, size, self._read(_box_key(key, off), size)))
        dims = len(parts[0][0])
        whole = torch.empty(tuple(max(o[d] + s[d] for o, s, _ in parts)
                                  for d in range(dims)), dtype=self.dtype(key))

        def assemble(r, parts=parts, whole=whole):
            for off, size, buf in parts:
                whole[tuple(slice(o, o + s) for o, s in zip(off, size))] = buf
            target.copy_(whole if index is None else whole[np.ix_(*index)])
        self._after.append(assemble)

    def run(self) -> None:
        import torch.distributed.checkpoint as dcp

        loaded: Dict[str, Any] = {}
        for path, want in self._reads.items():
            dcp.load(want, storage_reader=dcp.FileSystemReader(path), no_dist=True)
            loaded.update(want)
        with torch.no_grad():
            for fn in self._after:
                fn(loaded)
        self._reads, self._after = {}, []


def _model_reads(reader: _Reader, model: torch.nn.Module) -> None:
    """Plans every state-dict entry of ``model`` read into this rank's part
    of it, in place."""
    plan = plan_of(model)
    for k, v in model.state_dict().items():
        spec = None if plan is None else plan.specs.get(k)
        index = plan.index(spec) if _sharded(spec) else None
        reader.fill(f"model/{k}", v, index,
                    whole_shape=tuple(spec.shape) if spec is not None else tuple(v.shape))


def save_checkpoint_orbax(manager: CheckpointManager, step: int,
                          model: torch.nn.Module, optimizer=None,
                          meta: Optional[Dict[str, Any]] = None) -> None:
    """Async save of ``model`` (and ``optimizer``) as ``step`` (JAX
    ``save_checkpoint_orbax``): a step that exists is replaced, so the later
    meta wins. Every rank of a world calls it."""
    manager.save(step, orbax_items(model, optimizer), dict(meta or {}))


def load_checkpoint_orbax(manager: CheckpointManager, model: torch.nn.Module,
                          optimizer=None, step: Optional[int] = None
                          ) -> Dict[str, Any]:
    """Restores ``model`` (and ``optimizer``) in place from ``step`` (None:
    the latest complete step), each rank reading its own parts, after any
    save in flight; returns the meta (JAX ``load_checkpoint_orbax``)."""
    manager.wait_until_finished()
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {manager.directory}")
    path = manager.step_dir(step)
    reader = _Reader(path)
    _model_reads(reader, model)
    if optimizer is not None:
        objects, state, acc = _optimizer_reads(reader, optimizer)
    reader.run()
    if optimizer is not None:
        optimizer.load_local_state(objects["value"], state, acc)
    with open(os.path.join(path, ORBAX_META)) as f:
        meta = json.load(f)
    logger.info("Loaded checkpoint %s (epoch=%s, step=%s)", path,
                meta.get("epoch"), meta.get("step"))
    return meta


def _optimizer_reads(reader: _Reader, optimizer):
    """Plans the optimizer's state in this rank's layout, from the
    checkpoint's keys (the state may not exist yet in a fresh optimizer):
    (holder of the objects, the base state by index, the accumulation
    mean), for ``Optimizer.load_local_state`` once read."""
    objects = reader.obj(_OBJECTS)
    plan = optimizer.plan
    state: Dict[int, Dict[str, Any]] = {}
    for i, (name, t, spec, zero) in enumerate(optimizer.base_entries()):
        prefix = f"optim/{name}/"
        keys = {k[len(prefix):].partition("@")[0]
                for k in itertools.chain(reader.where, reader.boxes)
                if k.startswith(prefix) and "/" not in k[len(prefix):]}
        for k in sorted(keys):
            key = prefix + k
            if key in reader.where and not reader.meta[key].size:
                target = torch.empty((), dtype=reader.dtype(key))
                reader.fill(key, target)
            else:
                whole = tuple(spec.shape) if spec is not None else tuple(t.shape)
                index = (plan.index(spec, zero)
                         if zero or _sharded(spec) else None)
                shape = whole if index is None else tuple(len(x) for x in index)
                target = torch.empty(shape, dtype=reader.dtype(key),
                                     device=t.device)
                reader.fill(key, target, index, whole_shape=whole)
            state.setdefault(i, {})[k] = target
    acc = []
    for name, p, spec in zip(optimizer.names, optimizer.params, optimizer.specs):
        key = f"optim.acc/{name}"
        if key not in reader:
            break
        index = plan.index(spec) if _sharded(spec) else None
        target = torch.empty_like(p)
        reader.fill(key, target, index,
                    whole_shape=tuple(spec.shape) if spec is not None else tuple(p.shape))
        acc.append(target)
    return objects, state, acc


def load_params_orbax(path: str, model: torch.nn.Module) -> int:
    """The parameters of an orbax-backend directory's latest complete step
    into ``model``, in one process with no world: each tensor whole,
    assembled from every rank's parts, then cut to the model's own leg if
    it has one. Returns the step read."""
    steps = complete_steps(path)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {path}")
    step = steps[-1]
    reader = _Reader(os.path.join(path, str(step)))
    plan = plan_of(model)
    if plan is None:
        _model_reads(reader, model)
        reader.run()
        return step
    whole = {}
    for k, v in model.state_dict().items():
        spec = plan.specs.get(k)
        shape = tuple(spec.shape) if spec is not None else tuple(v.shape)
        whole[k] = torch.empty(shape, dtype=v.dtype)
        reader.fill(f"model/{k}", whole[k], whole_shape=shape)
    reader.run()
    load_full_state_dict(model, whole, strict=True)
    return step


def dump_config_snapshot(directory: str, cfg) -> None:
    """The config tree as ``global.json`` (the JAX version writes
    ``global.yaml``; JSON needs no PyYAML), by rank 0."""
    if rank() != 0:
        return
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "global.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=1, default=str)


def _version() -> str:
    from simseg_tpu_torch import __version__

    return __version__
