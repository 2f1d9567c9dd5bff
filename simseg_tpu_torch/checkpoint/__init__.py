"""Checkpoints: the port's own and the reference ``.pth`` (port of
``simseg_tpu/checkpoint``).

JAX's public table (``simseg_tpu/checkpoint/__init__.py``), each name
imported from its submodule on first use, so ``import
simseg_tpu_torch.checkpoint`` imports no submodule. JAX names with no
counterpart (``NO_COUNTERPART``): ``torch_to_flax``, ``flax_to_torch`` and
``clip_mapping_table``, JAX's conversion between the reference's torch
names and the flax tree, and its table of the pairs. The port's parameters
are a torch state dict already: ``torch_bridge.load_clip_checkpoint``
loads the reference names, and ``convert.reference_state_dict`` gives them
(``torch_export.save_clip_checkpoint`` writes them).
"""

from __future__ import annotations

import torch

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.checkpoint.{module}", name)
           for module, names in (
               ("native", ("dump_config_snapshot", "has_checkpoint",
                           "load_checkpoint", "load_params",
                           "save_checkpoint")),
               ("torch_bridge", ("convert_keys", "load_clip_checkpoint",
                                 "load_torch_state_dict")),
               ("torch_export", ("save_clip_checkpoint",)),
           ) for name in names}
NO_COUNTERPART = ("torch_to_flax", "flax_to_torch", "clip_mapping_table")
__all__ = sorted(list(_PUBLIC) + ["load_pretrained_params"])
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)


def load_pretrained_params(path: str, model: torch.nn.Module,
                           strict: bool = False) -> torch.nn.Module:
    """Load a model's parameters in place from either checkpoint family,
    chosen by extension (JAX ``load_pretrained_params``, :21-35): a
    reference ``.pth`` / ``.pt`` through ``torch_bridge.load_clip_checkpoint``
    (``pos_embed`` resampled to the model's grid; ``strict`` refuses
    missing or mismatched keys), anything else as the port's own
    checkpoint: a msgpack checkpoint directory or ``ckpt.dir``, or an
    orbax-backend directory of step directories, its latest complete step
    read whole (``native.load_params``). Returns ``model``."""
    if path.endswith((".pth", ".pt")):
        from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint

        load_clip_checkpoint(path, model, strict=strict)
    else:
        from simseg_tpu_torch.checkpoint.native import load_params

        load_params(path, model)
    return model
