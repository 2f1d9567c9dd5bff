"""Native checkpoint save/restore with step metadata and auto-resume (port
of ``simseg_tpu/checkpoint/native.py``, its msgpack backend; the orbax
backend is not ported).

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
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "train_state.pt"
META_FILE = "meta.json"
LATEST = "latest_ckpt"


def save_checkpoint(directory: str, name: str, model: torch.nn.Module,
                    optimizer=None, meta: Optional[Dict[str, Any]] = None,
                    make_latest: bool = True) -> str:
    """Write ``model`` (and ``optimizer``) under ``directory/name``; returns
    the path (JAX ``save_checkpoint``)."""
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

    state = {"model": model.state_dict(), "step": meta.get("step", 0)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
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
    model.load_state_dict(state["model"], strict=True)
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
    """Only the model's parameters from a checkpoint directory, or from a
    ``ckpt.dir``-style parent through its ``latest_ckpt`` pointer (external
    pretrained init: no optimizer state, no step)."""
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        path = _resolve(path, None)
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=next(model.parameters()).device,
                       weights_only=True)
    model.load_state_dict(state["model"], strict=True)


def has_checkpoint(directory: str) -> bool:
    link = os.path.join(directory, LATEST)
    if not os.path.exists(link):
        return False
    with open(link) as f:
        name = f.read().strip()
    return os.path.exists(os.path.join(directory, name, STATE_FILE))


def dump_config_snapshot(directory: str, cfg) -> None:
    """The config tree as ``global.json`` (the JAX version writes
    ``global.yaml``; JSON needs no PyYAML)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "global.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=1, default=str)


def _version() -> str:
    from simseg_tpu_torch import __version__

    return __version__
