"""ConvNeXt image tower returning the spatial feature map (port of
``simseg_tpu/models/convnext.py``).

Parity: reference ``simseg/models/backbones/mml/timm_builder.py:7-20``
(any timm tag, ``num_classes=0``, ``global_pool=''``): the un-pooled map
with the head's LayerNorm applied over the channels (timm 0.6.13
``forward_head`` with identity pooling). Module and parameter names are
timm's (``stem.0`` / ``.1``, ``stages.i.downsample.0`` / ``.1``,
``stages.i.blocks.j.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``, ``head.norm``).

As in JAX: a 7x7 depthwise conv, LayerNorm over the channels (eps 1e-6,
statistics in float32), exact-erf GELU in every dtype, and the layer scale
``gamma`` kept in float32 and cast at use. The stem (4x4, stride 4) and the
downsampling convs (2x2, stride 2) pad as flax's default ``'SAME'``
(``models/layers.same_pad``), so a size that the stride does not divide
keeps its last rows, as in JAX. The tower computes on an NCHW view with
channels-last strides; the blocks' LayerNorm and linears run on the NHWC
permute of it, as timm's block does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, same_pad


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Mlp(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim)
        self.fc2 = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_dw(x).permute(0, 2, 3, 1)
        h = self.mlp(self.norm(h))
        return x + (self.gamma.to(h.dtype) * h).permute(0, 3, 1, 2)


class _Stage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, first: bool) -> None:
        super().__init__()
        self.downsample = None if first else nn.Sequential(
            LayerNorm2d(cin, eps=1e-6), Conv2d(cin, dim, 2, stride=2))
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample[1](same_pad(self.downsample[0](x), 2, 2))
        for blk in self.blocks:
            x = blk(x)
        return x


class ConvNeXt(nn.Module):
    """(B, H, W, 3) -> the (B, h, w, C) map, head LayerNorm included."""

    quant = None

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768)) -> None:
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4),
                                  LayerNorm2d(dims[0], eps=1e-6))
        cins = (dims[0],) + tuple(dims[:-1])
        self.stages = nn.ModuleList(
            _Stage(cin, dim, depth, i == 0)
            for i, (cin, dim, depth) in enumerate(zip(cins, dims, depths)))
        self.head = nn.Module()
        self.head.norm = LayerNorm(dims[-1], eps=1e-6)
        self.num_features = dims[-1]
        self.patch_size = 4 * 2 ** (len(dims) - 1)
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, images: torch.Tensor, key=None,
                train_bn: bool = False) -> torch.Tensor:
        # train_bn: the CNN towers' signature (ConvNeXt has no BatchNorm)
        dtype = self.compute_dtype or self.stem[0].weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = self.stem[1](self.stem[0](same_pad(x, 4, 4)))
        for stage in self.stages:
            x = stage(x)
        return self.head.norm(x.permute(0, 2, 3, 1))


# timm 0.6.13's size table (JAX ``simseg_tpu/models/convnext.py:90-100``)
_CONVNEXT_SIZES = {
    "atto": dict(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320)),
    "femto": dict(depths=(2, 2, 6, 2), dims=(48, 96, 192, 384)),
    "pico": dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512)),
    "nano": dict(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640)),
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
}

CONVNEXT_CONFIGS = {
    "convnext_test": dict(depths=(1, 1), dims=(8, 16)),
}


def resolve_convnext_config(tag: str):
    """convnext_<size>[_*][.weights] -> spec, or None if not a ConvNeXt tag."""
    if tag in CONVNEXT_CONFIGS:
        return dict(CONVNEXT_CONFIGS[tag])
    parts = tag.split(".")[0].split("_")
    if parts[0] != "convnext" or len(parts) < 2:
        return None
    spec = _CONVNEXT_SIZES.get(parts[1])
    return dict(spec) if spec else None


def build_convnext(tag: str, arch: Optional[dict] = None) -> ConvNeXt:
    spec = resolve_convnext_config(tag) or {}
    if arch:
        spec.update({k: v for k, v in dict(arch).items() if v is not None})
    if "dims" not in spec:
        raise KeyError(
            f"Unknown ConvNeXt tag '{tag}'. Known sizes: "
            f"{sorted(_CONVNEXT_SIZES)}; or declare "
            "model.image_encoder.arch={'depths': ..., 'dims': ...}."
        )
    spec["depths"] = tuple(spec["depths"])
    spec["dims"] = tuple(spec["dims"])
    return ConvNeXt(**spec)
