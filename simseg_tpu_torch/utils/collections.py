"""Attribute-access config dict with recursive freezing (port of
``simseg_tpu/utils/collections.py``, a copy: the port imports nothing of
the JAX package).

Parity: reference ``simseg/utils/collections.py:8-50`` (AttrDict). The
semantics we keep: attribute read/write mirrors item read/write, nested dicts
are converted on insertion, and a recursive immutability latch protects the
config after startup. Everything else (iteration order, repr) is plain dict.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

_IMMUTABLE = "__adict_immutable__"


class OpenDict(dict):
    """A plain-dict config leaf: YAML/CLI values replace it wholesale with
    no strict key checking (parity: the reference task banks store optimizer
    / scheduler params as plain dicts, and _merge_a_into_b only recurses
    strictly into AttrDicts, core/config.py:198-203)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class AttrDict(dict):
    """dict with attribute access and a recursive immutable flag."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        object.__setattr__(self, _IMMUTABLE, False)
        init = dict(*args, **kwargs)
        for k, v in init.items():
            self[k] = v

    # -- conversion ---------------------------------------------------------
    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, (AttrDict, OpenDict)):
            return value
        if isinstance(value, Mapping):
            return AttrDict(value)
        if isinstance(value, (list, tuple)):
            seq = [AttrDict._convert(v) for v in value]
            return type(value)(seq) if isinstance(value, tuple) else seq
        return value

    # -- mutation guard ------------------------------------------------------
    def _check_mutable(self) -> None:
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(
                "This AttrDict is immutable; mutate before freezing or call "
                "set_immutable(False) first."
            )

    def __setitem__(self, key: Any, value: Any) -> None:
        self._check_mutable()
        super().__setitem__(key, AttrDict._convert(value))

    def __delitem__(self, key: Any) -> None:
        self._check_mutable()
        super().__delitem__(key)

    # -- attribute protocol ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- freezing --------------------------------------------------------------
    def set_immutable(self, flag: bool = True) -> None:
        """Recursively (un)freeze this dict and every nested AttrDict."""
        object.__setattr__(self, _IMMUTABLE, flag)
        for v in self.values():
            _freeze_nested(v, flag)

    # Alias matching the reference public name (collections.py:38).
    def set_this_dict_immutable(self, flag: bool = True) -> None:
        self.set_immutable(flag)

    @property
    def is_immutable(self) -> bool:
        return object.__getattribute__(self, _IMMUTABLE)

    def to_dict(self) -> dict:
        """Plain-primitive deep copy (dict/list/scalars only — safe for
        yaml.safe_dump config snapshots)."""
        return _plainify(self)

    def __deepcopy__(self, memo: dict) -> "AttrDict":
        new = AttrDict()
        memo[id(self)] = new
        for k, v in self.items():
            dict.__setitem__(new, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        object.__setattr__(new, _IMMUTABLE, object.__getattribute__(self, _IMMUTABLE))
        return new


def _plainify(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _plainify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plainify(v) for v in value]
    return copy.copy(value)


def _freeze_nested(value: Any, flag: bool) -> None:
    if isinstance(value, AttrDict):
        value.set_immutable(flag)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _freeze_nested(v, flag)
