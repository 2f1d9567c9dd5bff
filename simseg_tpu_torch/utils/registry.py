"""Name -> factory registries (port of ``simseg_tpu/utils/registry.py``).

Parity: reference ``simseg/utils/registry.py:7-81`` (Registry,
build_from_cfg). A registry maps a string name to a callable factory; the
build helper resolves ``name`` and calls ``factory(cfg, **kwargs)``. The
port's tables are JAX's four: ``PIPELINE`` (``models/clip.py``),
``DATALOADER`` (``data/datasets.py``), ``TRANSFORMS``
(``data/transforms.py``) and ``LR`` (``core/lr_schedule.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str) -> None:
        self._name = name
        self._objs: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def __contains__(self, key: str) -> bool:
        return key in self._objs

    def __iter__(self) -> Iterator[str]:
        return iter(self._objs)

    def keys(self):
        return self._objs.keys()

    def get(self, key: str) -> Callable:
        try:
            return self._objs[key]
        except KeyError:
            raise KeyError(
                f"'{key}' is not registered in {self._name}; "
                f"available: {sorted(self._objs)}") from None

    def register(self, obj: Optional[Callable] = None, *,
                 name: Optional[str] = None):
        """Use as ``@REG.register``, ``@REG.register(name='alias')`` or
        ``REG.register(fn, name=...)``."""
        if obj is None:
            def deco(fn: Callable) -> Callable:
                self._register(fn, name)
                return fn
            return deco
        self._register(obj, name)
        return obj

    # the reference's name (registry.py:30, register_obj)
    register_obj = register

    def _register(self, obj: Callable, name: Optional[str]) -> None:
        key = name or obj.__name__
        if key in self._objs:
            raise KeyError(f"'{key}' already registered in {self._name}")
        self._objs[key] = obj


def build_from_cfg(name: str, cfg: Any, registry: Registry, **kwargs: Any):
    """Resolve ``name`` in ``registry`` and call it with the config."""
    return registry.get(name)(cfg, **kwargs)
