"""Runners, hooks, optimizers and lr schedules (port of ``simseg_tpu/core``).

JAX's public table (``simseg_tpu/core/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.core``
imports no submodule. Every JAX name has a counterpart.
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {"LR": ("simseg_tpu_torch.core.lr_schedule", "LR"),
           "build_schedule": ("simseg_tpu_torch.core.lr_schedule",
                              "build_schedule"),
           "build_optimizer": ("simseg_tpu_torch.core.optim",
                               "build_optimizer")}
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
