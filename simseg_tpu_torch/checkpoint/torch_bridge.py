"""Loading reference ``.pth`` checkpoints into the port's ``CLIPModel`` (port
of ``simseg_tpu/checkpoint/torch_bridge.py``: ``load_torch_state_dict``,
``convert_keys`` and ``load_clip_checkpoint``, :39-80 and :373-475).

The port's modules carry the reference's timm/HF state-dict names, so no
layout table is needed: a name either is a key of the model's state dict
or is unexpected. What the JAX loader does around its table is kept:
- the reference's containers ``{state_dict|model|model_state_dict: ...}``
  are unwrapped and a ``module.`` prefix is stripped per key
  (reference ``tasks/clip/hooks/checkpoint.py:58-76``);
- ``'old->new'`` prefix rules (reference ``utils/checkpoint_utils.py:4-20``);
- ``only_image_encoder`` / ``only_text_encoder`` keep the ``image_`` /
  ``text_`` names (projection heads included, as the reference's substring
  filter does) and force ``strict`` off;
- a ``pos_embed`` on another grid is resampled bicubically
  (``ops/interpolate_pe.py``; reference ``tools/seg_evaluation.py:228-231``);
- a report of the four buckets of ``filter_state``: matched, mismatched
  (name, file shape, model shape), missing, unexpected.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import torch

from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed
from simseg_tpu_torch.parallel.sharding import full_shapes, load_full_state_dict

logger = logging.getLogger(__name__)

_CONTAINERS = ("state_dict", "model", "model_state_dict")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat ``{name: float32 tensor}`` dict on the
    CPU: the reference's full checkpoint or a bare state dict, tensors
    only, ``module.`` stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in _CONTAINERS:
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    out: Dict[str, torch.Tensor] = {}
    for name, value in obj.items():
        if isinstance(value, torch.Tensor):
            name = name[len("module."):] if name.startswith("module.") else name
            out[name] = value.detach().to(torch.float32)
    return out


def convert_keys(state: Dict[str, torch.Tensor],
                 rules: List[str]) -> Dict[str, torch.Tensor]:
    """Apply ``'old_prefix->new_prefix'`` rules; the first that matches a
    name wins."""
    out = {}
    for name, value in state.items():
        for rule in rules:
            old, _, new = rule.partition("->")
            if name.startswith(old):
                name = new + name[len(old):]
                break
        out[name] = value
    return out


def load_state_into(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                    strict: bool = False) -> dict:
    """Copy ``state`` into ``model`` where names and shapes agree
    (``pos_embed`` resampled to the model's grid first). Returns the
    four-bucket report; with ``strict`` a missing or mismatched entry
    raises before anything is copied."""
    target = full_shapes(model)
    loaded: Dict[str, torch.Tensor] = {}
    matched, mismatched, unexpected = [], [], []
    for name, value in state.items():
        want = target.get(name)
        if want is None:
            unexpected.append(name)
            continue
        if name.endswith("pos_embed") and tuple(value.shape) != want:
            n_new = want[1]
            extra = n_new - int(round((n_new - 1) ** 0.5)) ** 2
            value = interpolate_pos_embed(value, n_new - extra, extra)
            logger.info("interpolated %s %s -> %s", name,
                        tuple(state[name].shape), tuple(value.shape))
        if tuple(value.shape) != want:
            mismatched.append((name, tuple(value.shape), want))
            continue
        loaded[name] = value
        matched.append(name)
    missing = [name for name in target if name not in loaded]
    report = {"matched": matched, "mismatched": mismatched,
              "missing": missing, "unexpected": unexpected}
    if strict and (missing or mismatched):
        raise ValueError(f"strict load failed: {len(missing)} missing, "
                         f"{len(mismatched)} mismatched: {report}")
    load_full_state_dict(model, loaded, strict=strict)
    logger.info("torch checkpoint: %d matched, %d shape-mismatched, %d "
                "missing, %d unexpected", len(matched), len(mismatched),
                len(missing), len(unexpected))
    return report


def load_clip_checkpoint(path: str, model: torch.nn.Module,
                         prefix_rules: Optional[List[str]] = None,
                         only_image_encoder: bool = False,
                         only_text_encoder: bool = False,
                         strict: bool = False) -> dict:
    """Load a reference SimSeg checkpoint into the port's ``CLIPModel`` in
    place; returns the four-bucket report (JAX ``load_clip_checkpoint``)."""
    state = load_torch_state_dict(path)
    if prefix_rules:
        state = convert_keys(state, prefix_rules)
    if only_image_encoder:
        state = {k: v for k, v in state.items() if k.startswith("image_")}
    if only_text_encoder:
        state = {k: v for k, v in state.items() if k.startswith("text_")}
    if only_image_encoder or only_text_encoder:
        # a tower filter leaves the other tower missing by design
        strict = False
    return load_state_into(model, state, strict=strict)
