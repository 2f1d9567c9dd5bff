"""Config trees, logging, registries, metrics and prompts (port of
``simseg_tpu/utils``).

JAX's public table (``simseg_tpu/utils/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.utils``
imports no submodule. Every JAX name has a counterpart. ``logger`` is the
logger, as in JAX, also once the ``logger`` submodule is imported (the
import would otherwise set the package's ``logger`` to that module).
"""

import sys
import types

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.utils.{module}", name)
           for module, names in (
               ("collections", ("AttrDict",)),
               ("logger", ("logger",)),
               ("registry", ("Registry", "build_from_cfg")),
               ("metrics", ("intersect_and_union", "mean_iou",
                            "miou_from_totals", "topk_accuracy")),
               ("prompts", ("IMAGENET_TEMPLATES", "openai_imagenet_template")),
           ) for name in names}
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)


class _Utils(types.ModuleType):
    def __setattr__(self, name, value):
        if name == "logger" and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Utils
