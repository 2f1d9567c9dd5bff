"""Write a model as the reference's ``{'state_dict', 'meta'}`` torch
checkpoint (port of ``simseg_tpu/checkpoint/torch_export.py:339-366``,
``save_clip_checkpoint``).

The port's state dict already holds the reference's timm/HF names and
layouts (``checkpoint/convert.py``); ``reference_state_dict`` leaves out
the MoE leaves, which have no slot there (``strict`` raises on them, as
JAX's ``flax_to_torch`` does). The file is the container the reference's
CheckpointHook emits and its eval tools read with ``strict=True``; it
loads back through ``checkpoint/torch_bridge.load_clip_checkpoint`` (and
JAX's) bit for bit.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Union

import torch

from simseg_tpu_torch.checkpoint.convert import reference_state_dict
from simseg_tpu_torch.parallel.mesh import rank
from simseg_tpu_torch.parallel.sharding import full_state_dict

logger = logging.getLogger(__name__)


def save_clip_checkpoint(path: str,
                         model_or_state: Union[torch.nn.Module,
                                               Dict[str, torch.Tensor]],
                         meta: Optional[dict] = None,
                         strict: bool = True) -> Dict[str, List[str]]:
    """Writes ``model_or_state`` (a model, or its state dict) to ``path``
    as ``{'state_dict': ..., 'meta': meta}`` with ``torch.save``; returns
    the report of ``reference_state_dict`` (exported keys, skipped paths).
    Every tensor goes to the CPU, contiguous, its shape kept (the 0-d
    temperature stays 0-d). A sharded model is gathered whole first (every
    rank calls; rank 0 writes)."""
    if isinstance(model_or_state, torch.nn.Module):
        state = full_state_dict(model_or_state)
    else:
        state = dict(model_or_state)
    out, report = reference_state_dict(state, strict=strict)
    if rank() != 0:
        return report
    payload = {"state_dict": {k: v.detach().to("cpu").contiguous().clone()
                              for k, v in out.items()},
               "meta": dict(meta or {})}
    torch.save(payload, path)
    logger.info("Saved reference-layout torch checkpoint %s (%d tensors)",
                path, len(out))
    return report
