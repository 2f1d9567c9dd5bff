"""PyTorch/CUDA port of ``simseg_tpu`` for NVIDIA Hopper (H100).

The JAX package ``simseg_tpu`` is the reference; this package mirrors its
module names (``models/vit.py`` here ports ``simseg_tpu/models/vit.py``)
and its public layouts (NHWC images, (B, N, D) tokens, (B, K, H, W) maps),
but imports neither JAX nor anything of ``simseg_tpu``.

Entry points take ``device=None``, which means CUDA: there is no silent CPU
fallback. Only an explicit ``device="cpu"`` runs on the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.

The public API is JAX's lazy table (``simseg_tpu/__init__.py:27-43``),
each name mapped to the port's counterpart and imported on first use, so
``import simseg_tpu_torch`` loads no submodule; each subpackage does the
same with its JAX ``__all__`` (``lazy_package``). JAX's ``TrainState`` has
none: the port's state is the model and its ``core/optim.Optimizer``.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

# Lazy public API: a submodule loads on first use of one of its names.
_PUBLIC = {
    "cfg": ("simseg_tpu_torch.config", "cfg"),
    "update_cfg": ("simseg_tpu_torch.config", "update_cfg"),
    "AttrDict": ("simseg_tpu_torch.utils.collections", "AttrDict"),
    "logger": ("simseg_tpu_torch.utils.logger", "logger"),
    "ENV": ("simseg_tpu_torch.utils.context", "ENV"),
    "CLIPModel": ("simseg_tpu_torch.models.clip", "CLIPModel"),
    "build_clip_model": ("simseg_tpu_torch.models.clip", "build_clip_model"),
    "PIPELINE": ("simseg_tpu_torch.models.clip", "PIPELINE"),
    "DATALOADER": ("simseg_tpu_torch.data.datasets", "DATALOADER"),
    "make_train_step": ("simseg_tpu_torch.engine.train_step",
                        "make_train_step"),
    "CLIPRunner": ("simseg_tpu_torch.core.runner", "CLIPRunner"),
    "LinearProbRunner": ("simseg_tpu_torch.core.runner", "LinearProbRunner"),
    "make_mesh": ("simseg_tpu_torch.parallel.mesh", "make_mesh"),
    "load_clip_checkpoint": ("simseg_tpu_torch.checkpoint.torch_bridge",
                             "load_clip_checkpoint"),
}


def lazy_package(package: str, table: dict):
    """The module-level ``__getattr__`` and ``__dir__`` of a package whose
    public names (``table``: name -> (module, attribute)) load from their
    submodules on first use, so importing the package imports none."""

    def __getattr__(name):
        if name in table:
            import importlib

            module, attr = table[name]
            return getattr(importlib.import_module(module), attr)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def __dir__():
        import sys

        return sorted(set(vars(sys.modules[package])) | set(table))

    return __getattr__, __dir__


__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the rank's card, ``cuda:LOCAL_RANK`` (``cuda:0`` outside
    a ``torch.distributed`` launch, where ``LOCAL_RANK`` is unset);
    anything else as given.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    """
    if device is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0") or 0))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simseg_tpu_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain CPU path")
    return dev
