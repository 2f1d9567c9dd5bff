"""Seeded weights, made on the device in one draw.

The names and shapes are the reference layout's (``pbench_ref.clip.
param_shapes``: timm's ViT, HuggingFace's BERT, the SimSeg projections),
which the program's state dict carries too; the program loads them with
``strict=True``, so a layout that drifts stops the run instead of leaving a
tensor at its own initialisation. One ``randn`` over every element, in the
float32 the parameters are kept in, then a view a tensor:

- linear, convolution and embedding weights, biases, the class token and
  the position embeddings: N(0, 0.02^2), timm's and BERT's scale;
- LayerNorm scales: 1 + N(0, 0.02^2), so no scale is the identity;
- the temperature: the configuration's initial value.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pbench.data import TAG_WEIGHTS, generator

STD = 0.02


def _is_norm_scale(name: str, shape) -> bool:
    leaf = name.rsplit(".", 2)
    return (len(shape) == 1 and name.endswith(".weight")
            and ("norm" in leaf[-2].lower()))


def make_state(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
               temperature: float) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, views of one buffer."""
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    gen = generator(seed, TAG_WEIGHTS, device)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    flat.mul_(STD)
    state, at = {}, 0
    for name, size in zip(names, sizes):
        t = flat[at:at + size].view(shapes[name])
        at += size
        if name.endswith("temperature"):
            t.fill_(temperature)
        elif _is_norm_scale(name, shapes[name]):
            t.add_(1.0)
        state[name] = t
    return state
