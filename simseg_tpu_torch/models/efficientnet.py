"""EfficientNet image tower returning the spatial feature map (port of
``simseg_tpu/models/efficientnet.py``).

Parity: reference ``simseg/models/backbones/mml/timm_builder.py:7-20``
(any timm tag, ``num_classes=0``, ``global_pool=''``): the un-pooled map
after ``conv_head`` + ``bn2`` + SiLU (timm ``forward_features``). Module
and parameter names are timm 0.6.13's (``conv_stem``, ``bn1``,
``blocks.s.b.{conv_pw,conv_dw,conv_pwl,bn1..bn3,se.conv_reduce,
se.conv_expand}``, ``conv_head``, ``bn2``). The plain (non-``tf_``)
variants: symmetric padding, BN eps 1e-5 (flax's BatchNorm,
``models/layers.BatchNorm``); the squeeze-excite width is
max(1, int(in_chs · 0.25)) of the block's input channels, and its two 1x1
convs carry biases. Depthwise kernels are (C, 1, k, k), flax's (k, k, 1, C).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import BatchNorm, Conv2d


def round_channels(c: float, divisor: int = 8) -> int:
    """timm round_channels: nearest multiple of 8, never below 90%."""
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


class SqueezeExcite(nn.Module):
    def __init__(self, chs: int, rd_chs: int) -> None:
        super().__init__()
        self.conv_reduce = Conv2d(chs, rd_chs, 1)
        self.conv_expand = Conv2d(rd_chs, chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


def _dw(chs: int, kernel: int, stride: int) -> Conv2d:
    return Conv2d(chs, chs, kernel, stride=stride, padding=kernel // 2,
                  groups=chs, bias=False)


class DepthwiseSeparable(nn.Module):
    """timm DepthwiseSeparableConv (expand ratio 1): dw conv -> bn1 -> SiLU
    -> SE -> pw conv -> bn2, the residual where shapes agree."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3,
                 stride: int = 1, se_ratio: float = 0.25) -> None:
        super().__init__()
        self.conv_dw = _dw(in_chs, kernel, stride)
        self.bn1 = BatchNorm(in_chs)
        self.se = SqueezeExcite(in_chs, max(1, int(in_chs * se_ratio)))
        self.conv_pw = Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = BatchNorm(out_chs)
        self.residual = stride == 1 and in_chs == out_chs

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv_dw(x), train_bn))
        h = self.bn2(self.conv_pw(self.se(h)), train_bn)
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """timm InvertedResidual (MBConv): pw expand -> dw -> SE -> pw project."""

    def __init__(self, in_chs: int, out_chs: int, expand: int = 6,
                 kernel: int = 3, stride: int = 1,
                 se_ratio: float = 0.25) -> None:
        super().__init__()
        mid = in_chs * expand
        self.conv_pw = Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = _dw(mid, kernel, stride)
        self.bn2 = BatchNorm(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_chs * se_ratio)))
        self.conv_pwl = Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = BatchNorm(out_chs)
        self.residual = stride == 1 and in_chs == out_chs

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv_pw(x), train_bn))
        h = F.silu(self.bn2(self.conv_dw(h), train_bn))
        h = self.bn3(self.conv_pwl(self.se(h)), train_bn)
        return h + x if self.residual else h


# base (b0) stage table: (expand, channels, repeats, stride, kernel)
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class EfficientNet(nn.Module):
    """(B, H, W, 3) -> the (B, h, w, head_chs) map."""

    quant = None

    def __init__(self, stages: Sequence[Tuple[int, int, int, int, int]] = _B0_STAGES,
                 stem_chs: int = 32, head_chs: int = 1280,
                 se_ratio: float = 0.25) -> None:
        super().__init__()
        self.conv_stem = Conv2d(3, stem_chs, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(stem_chs)
        cin, stride_total = stem_chs, 2
        blocks = []
        for expand, chs, repeats, stride, kernel in stages:
            stage = []
            for b in range(repeats):
                st = stride if b == 0 else 1
                if expand == 1:
                    stage.append(DepthwiseSeparable(cin, chs, kernel, st, se_ratio))
                else:
                    stage.append(InvertedResidual(cin, chs, expand, kernel, st,
                                                  se_ratio))
                cin = chs
            stride_total *= stride
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        self.conv_head = Conv2d(cin, head_chs, 1, bias=False)
        self.bn2 = BatchNorm(head_chs)
        self.num_features = head_chs
        self.patch_size = stride_total
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, images: torch.Tensor, key=None,
                train_bn: bool = False) -> torch.Tensor:
        dtype = self.compute_dtype or self.conv_stem.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = F.silu(self.bn1(self.conv_stem(x), train_bn))
        for stage in self.blocks:
            for blk in stage:
                x = blk(x, train_bn)
        x = F.silu(self.bn2(self.conv_head(x), train_bn))
        return x.permute(0, 2, 3, 1)


# (width_mult, depth_mult) per variant
_EFFNET_MULTS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}

EFFICIENTNET_CONFIGS = {
    "efficientnet_test": dict(
        stages=((1, 8, 1, 1, 3), (6, 16, 2, 2, 3)),
        stem_chs=8, head_chs=32),
}


def scaled_stages(width: float, depth: float):
    return tuple(
        (e, round_channels(c * width), int(math.ceil(r * depth)), s, k)
        for e, c, r, s, k in _B0_STAGES
    )


def resolve_efficientnet_config(tag: str):
    """efficientnet_b<N>[.weights] -> spec, or None if not an EfficientNet
    tag resolved here (``tf_`` / lite / v2 variants differ in padding or
    ops and are refused rather than mis-built)."""
    if tag in EFFICIENTNET_CONFIGS:
        return dict(EFFICIENTNET_CONFIGS[tag])
    parts = tag.split(".")[0].split("_")
    if parts[0] != "efficientnet" or len(parts) != 2:
        return None
    mults = _EFFNET_MULTS.get(parts[1])
    if mults is None:
        return None
    w, d = mults
    return dict(stages=scaled_stages(w, d),
                stem_chs=round_channels(32 * w),
                head_chs=round_channels(1280 * w))


def build_efficientnet(tag: str, arch: Optional[dict] = None) -> EfficientNet:
    spec = resolve_efficientnet_config(tag) or {}
    if arch:
        spec.update({k: v for k, v in dict(arch).items() if v is not None})
    if "stages" not in spec:
        raise KeyError(
            f"Unknown EfficientNet tag '{tag}'. Supported: efficientnet_b0.."
            "b7 (plain variants; tf_/lite/v2 differ in padding or ops and "
            "are not implemented), or declare model.image_encoder.arch="
            "{'stages': ..., 'stem_chs': ..., 'head_chs': ...}."
        )
    spec["stages"] = tuple(tuple(s) for s in spec["stages"])
    return EfficientNet(**spec)
