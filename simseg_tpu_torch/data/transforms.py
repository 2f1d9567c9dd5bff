"""Device-side image normalisation (port of
``simseg_tpu/data/transforms.py:503-511``)."""

from __future__ import annotations

from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_u8: torch.Tensor,
                     mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """ToTensor + Normalize: (B, H, W, 3) uint8 -> normalised float32 NHWC."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
