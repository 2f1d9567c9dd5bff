"""Global config tree: task defaults -> strict YAML merge -> dotted CLI
overrides -> preprocess -> freeze (port of ``simseg_tpu/config.py``, the
same keys, merge rules and override grammar; ``yaml`` is imported only when
a file is given, so a tree built from defaults and overrides alone needs no
PyYAML).

Parity: reference ``simseg/core/config.py`` —
- base key declaration (:13-98)
- ``update_cfg`` 5-stage pipeline (:101-139)
- strict unknown-key rejection on YAML merge (:182-205)
- CLI override grammar ``a.b.c=value`` with literal-eval decoding and type
  coercion against the existing value (:143-179, :245-309).

The tree itself is an :class:`~simseg_tpu_torch.utils.collections.AttrDict`; after
``update_cfg`` it is frozen. Code that needs a scratch copy should deepcopy.
"""

from __future__ import annotations

import ast
import copy
import logging
from typing import Any, Callable, List, Optional, Sequence

from simseg_tpu_torch.utils.collections import AttrDict, OpenDict

logger = logging.getLogger(__name__)


def new_base_cfg() -> AttrDict:
    """Declare the framework-level base keys (parity: config.py:13-98)."""
    cfg = AttrDict()

    cfg.epoch = 1
    cfg.seed = None
    cfg.inference = False

    cfg.runner = AttrDict()
    cfg.runner.name = "clip"
    cfg.runner.val_interval = 1
    cfg.runner.val_interval_steps = -1

    cfg.dist = AttrDict()
    # TPU-native: 'jax' means jax.distributed + mesh collectives. bf16 is the
    # native mixed-precision mode (no loss scaler needed on TPU).
    cfg.dist.name = "jax"
    cfg.dist.bf16 = True
    cfg.dist.fp16 = False  # accepted for reference-config compatibility
    cfg.dist.param = OpenDict()
    # beyond-reference mesh knobs: tensor parallelism (devices per model
    # replica, parallel/tp.py) and ZeRO-1 optimizer-state sharding
    cfg.dist.tp_size = 1
    cfg.dist.zero1 = False
    cfg.dist.sp = False  # sequence-parallel residual stream (needs tp_size>1)
    cfg.dist.fsdp = False  # ZeRO-3-style fully-sharded params over 'data'

    cfg.model = AttrDict()
    cfg.model.name = ""

    cfg.data = AttrDict()
    cfg.data.name = ""
    cfg.data.batch_size = 1
    cfg.data.batch_size_val = 1
    cfg.data.train_steps = -1
    cfg.data.val_steps = -1
    cfg.data.native_decode = True  # C++ decode fast path (data/native.py)
    # batches staged to device ahead of the running step (shard_batch +
    # normalize off the critical path); 0 disables
    cfg.data.device_prefetch = 2

    cfg.optim = AttrDict()
    cfg.optim.name = "adamw"
    cfg.optim.param = OpenDict()
    cfg.optim.param_group_rules = OpenDict()
    cfg.optim.grad_clip = OpenDict()
    cfg.optim.skip_nonfinite = 0  # >0: skip non-finite updates (NaN guard)
    cfg.optim.grad_accum_steps = 1  # >1: average grads over k steps (optax
    # MultiSteps; micro-batch-local negatives — see core/optim.py; for exact
    # big-batch InfoNCE use runner.name='clip_bsgs')
    cfg.optim.lr = AttrDict()
    cfg.optim.lr.name = "constant_schedule"
    cfg.optim.lr.init = 1e-4
    cfg.optim.lr.warmup_proportion = 0.0
    cfg.optim.lr.param = OpenDict()

    cfg.ckpt = AttrDict()
    cfg.ckpt.dir = "./output"
    cfg.ckpt.step_interval = 2000
    cfg.ckpt.filename = "step_checkpoint"
    cfg.ckpt.external_resume = None
    cfg.ckpt.auto_resume = True
    cfg.ckpt.soft_resume = False
    cfg.ckpt.backend = "msgpack"

    cfg.log = AttrDict()
    cfg.log.interval_train = 10
    cfg.log.interval_val = 1

    return cfg


# The module-level global config, mirroring the reference singleton
# (core/config.py:13). Entry points call update_cfg() on it once.
cfg = new_base_cfg()


# --------------------------------------------------------------------------
# merge / override machinery
# --------------------------------------------------------------------------

def _merge_a_into_b(a: dict, b: AttrDict, path: str = "") -> None:
    """Strict merge: every key in ``a`` must already exist in ``b``; plain
    OpenDict leaves (optimizer/scheduler param banks) are replaced wholesale
    without key checking (parity: config.py:182-205, which only recurses
    strictly into AttrDicts)."""
    for k, v in a.items():
        full = f"{path}.{k}" if path else str(k)
        if k not in b:
            raise KeyError(f"Unknown config key: {full}")
        if isinstance(b[k], OpenDict):
            b[k] = OpenDict(v) if isinstance(v, dict) else _coerce(v, b[k], full)
        elif isinstance(v, dict) and isinstance(b[k], AttrDict):
            _merge_a_into_b(v, b[k], full)
        else:
            b[k] = _coerce(v, b[k], full)


def _decode_value(text: str) -> Any:
    """Decode a CLI value string: literal-eval with auto-quoting of bare
    words (parity: config.py:208-276)."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    # auto-quote bare words inside list/tuple/dict syntax, e.g.
    # "[pascal_voc,coco]" -> ["pascal_voc", "coco"]
    stripped = text.strip()
    if stripped and stripped[0] in "[({":
        quoted = _quote_bare_words(stripped)
        try:
            return ast.literal_eval(quoted)
        except (ValueError, SyntaxError):
            pass
    lowered = stripped.lower()
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    if lowered in ("none", "null"):
        return None
    return text


def _quote_bare_words(text: str) -> str:
    out: List[str] = []
    token: List[str] = []

    def flush() -> None:
        if token:
            word = "".join(token)
            try:
                ast.literal_eval(word)
                out.append(word)
            except (ValueError, SyntaxError):
                out.append(repr(word))
            token.clear()

    for ch in text:
        if ch in "[](){},:":
            flush()
            out.append(ch)
        elif ch.isspace():
            flush()
        else:
            token.append(ch)
    flush()
    return "".join(out)


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Coerce ``new`` toward the type of ``old`` where unambiguous
    (parity: config.py:279-309)."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            return new.lower() in ("true", "1", "yes")
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if type(old) is type(new) or isinstance(old, AttrDict) or isinstance(new, dict):
        return new
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return new
    if isinstance(old, str) or isinstance(new, str):
        return new
    raise TypeError(
        f"Config override type mismatch for '{key}': "
        f"{type(old).__name__} -> {type(new).__name__}"
    )


def _update_from_argv(target: AttrDict, argv: Sequence[str]) -> None:
    """Apply ``a.b.c=value`` dotted overrides; unknown keys raise
    (parity: config.py:143-179)."""
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"CLI override must look like key=value, got: {arg}")
        key, _, raw = arg.partition("=")
        key = key.strip()
        parts = key.split(".")
        node = target
        for p in parts[:-1]:
            if not isinstance(node, (AttrDict, OpenDict)) or p not in node:
                raise KeyError(f"Unknown config key in CLI override: {key}")
            node = node[p]
        leaf = parts[-1]
        if isinstance(node, OpenDict):
            # open param bank: arbitrary leaf keys allowed
            node[leaf] = _decode_value(raw)
            continue
        if leaf not in node:
            raise KeyError(f"Unknown config key in CLI override: {key}")
        value = _decode_value(raw)
        if isinstance(node[leaf], OpenDict) and isinstance(value, dict):
            node[leaf] = OpenDict(value)
        else:
            node[leaf] = _coerce(value, node[leaf], key)


def update_cfg(
    task_cfg_init_fn: Optional[Callable[[AttrDict], None]],
    yaml_path: Optional[str],
    argv: Optional[Sequence[str]] = None,
    preprocess_fn: Optional[Callable[[AttrDict], None]] = None,
    target: Optional[AttrDict] = None,
    freeze: bool = True,
) -> AttrDict:
    """Five-stage config build (parity: config.py:101-139).

    1. ``task_cfg_init_fn`` seeds task defaults into the tree.
    2. YAML file strictly merged (unknown key -> error).
    3. Dotted CLI overrides applied.
    4. ``preprocess_fn`` for task-derived values.
    5. Freeze.
    """
    target = cfg if target is None else target
    if target.is_immutable:
        target.set_immutable(False)

    if task_cfg_init_fn is not None:
        task_cfg_init_fn(target)

    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            # UnsafeLoader only for parity with reference yaml tags like
            # `!!python/tuple`; configs are trusted local files.
            data = yaml.unsafe_load(f)
        if data:
            _merge_a_into_b(data, target)
        logger.info(f"Loaded config from {yaml_path}")

    if argv:
        _update_from_argv(target, argv)

    if preprocess_fn is not None:
        preprocess_fn(target)

    if freeze:
        target.set_immutable(True)
    return target


def cfg_snapshot(target: Optional[AttrDict] = None) -> AttrDict:
    return copy.deepcopy(cfg if target is None else target)
