"""Checkpoint loading (port of ``simseg_tpu/checkpoint/__init__.py``)."""

from __future__ import annotations

import torch


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
