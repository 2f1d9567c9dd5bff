"""Image transforms and device-side normalisation (port of
``simseg_tpu/data/transforms.py``: ``resize`` :40-43, ``resize_bicubic``
:46-57, ``center_crop`` :60-69, the ``TransformPipeline`` :307-352,
``build_transforms`` :496 and ``normalize_images`` :503-511).

The JAX package resizes with PIL. The resize here is PIL's resample
(``libImaging/Resample.c``) reproduced bit for bit in integer torch ops,
so that the same code runs on the CPU and on the card: per output pixel a
triangle (bilinear) or a = -0.5 cubic (bicubic) filter whose support
widens by the scale factor when the image shrinks, coefficients
normalised in float64 and held in fixed point with 22 fractional bits, a
horizontal pass rounded and clipped to uint8, then a vertical pass. A
pass is skipped where its side keeps its size, as PIL skips it.
``F.interpolate(antialias=True)`` computes in float and does not match.

Images are (H, W, 3) uint8 tensors on any device. Train mode runs PIL on
the host (``data/train_transforms.py``, imported only there), so the eval
path needs no PIL. The JAX package's native decode fast path
(``TransformPipeline.load``, ``data/native.py``) is not ported (ROADMAP
queue 1 item 10): ``data.native_decode`` is read as False.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

PRECISION_BITS = 32 - 8 - 2   # PIL's fixed point for 8-bit images


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = -x if x < 0.0 else x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=256)
def resample_coefficients(in_size: int, out_size: int, kind: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one side:
    (source index (out, taps) int64, fixed-point weight (out, taps) int64),
    unused taps weighted 0 at index 0."""
    filt, support = _FILTERS[kind]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, taps), np.int64)
    weight = np.zeros((out_size, taps), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            # C's (int) cast truncates toward zero
            weight[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << PRECISION_BITS))
            index[xx, x] = xmin + x
    return index, weight


def _pass(img: torch.Tensor, out_size: int, dim: int, kind: str) -> torch.Tensor:
    """One PIL resample pass along ``dim`` (0: rows, 1: columns) of an
    (H, W, C) uint8 tensor."""
    index, weight = resample_coefficients(img.shape[dim], out_size, kind)
    index = torch.from_numpy(index).to(img.device)
    weight = torch.from_numpy(weight).to(img.device)
    x = img.to(torch.int64)
    if dim == 0:
        acc = (x[index] * weight[:, :, None, None]).sum(1)          # (out, W, C)
    else:
        acc = (x[:, index] * weight[None, :, :, None]).sum(2)       # (H, out, C)
    acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return acc.clamp_(0, 255).to(torch.uint8)


def pil_resize(img: torch.Tensor, size: Tuple[int, int],
               kind: str = "bilinear") -> torch.Tensor:
    """``Image.resize((w, h), BILINEAR | BICUBIC)`` of an (H, W, C) uint8
    tensor, bit for bit: the horizontal pass first, then the vertical."""
    out_w, out_h = size
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {size}")
    if img.shape[1] != out_w:
        img = _pass(img, out_w, 1, kind)
    if img.shape[0] != out_h:
        img = _pass(img, out_h, 0, kind)
    return img


def pil_crop(img: torch.Tensor, left: int, top: int, width: int,
             height: int) -> torch.Tensor:
    """``Image.crop((left, top, left + width, top + height))``: the part
    outside the image reads 0, as PIL fills it."""
    h, w, c = img.shape
    out = torch.zeros((height, width, c), dtype=img.dtype, device=img.device)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + height, h), min(left + width, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def resize(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    size = cfg.transforms.resize.size
    return lambda img: pil_resize(img, (size, size), "bilinear")


def resize_bicubic(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    size = cfg.transforms.resize_bicubic.size

    def fn(img):
        h, w = img.shape[:2]
        if w < h:
            nw, nh = size, int(round(h * size / w))
        else:
            nw, nh = int(round(w * size / h)), size
        return pil_resize(img, (nw, nh), "bicubic")
    return fn


def center_crop(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    size = cfg.transforms.center_crop.size

    def fn(img):
        h, w = img.shape[:2]
        left = int(round((w - size) / 2.0))
        top = int(round((h - size) / 2.0))
        return pil_crop(img, left, top, size, size)
    return fn


VALID_OPS = {"resize": resize, "resize_bicubic": resize_bicubic,
             "center_crop": center_crop}


class TransformPipeline:
    """The config's ``valid_transforms`` composed: (H, W, 3) uint8 RGB ->
    uint8, on the image's device (normalisation runs later, on the batch,
    in ``normalize_images``)."""

    def __init__(self, cfg, mode: str = "valid"):
        if mode != "valid":
            raise ValueError(f"TransformPipeline takes mode 'valid', not "
                             f"{mode!r}; build_transforms(cfg, 'train') gives "
                             "the train pipeline")
        self.names: Sequence[str] = list(cfg.transforms.valid_transforms)
        self.mode = mode
        unknown = [n for n in self.names if n not in VALID_OPS]
        if unknown:
            raise NotImplementedError(
                f"valid transforms {unknown}: the eval path has "
                f"{sorted(VALID_OPS)} (deterministic, PIL-free); the random "
                "ops belong in train_transforms")
        self.ops: List[Callable] = [VALID_OPS[n](cfg) for n in self.names]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        for op in self.ops:
            img = op(img)
        return img


def build_transforms(cfg, mode: str = "valid"):
    """The composed ops of ``cfg.transforms`` for ``mode``: 'valid', a
    ``TransformPipeline``; 'train', ``train_transforms.TrainPipeline`` (PIL
    on the host, imported only here)."""
    if mode == "train":
        from simseg_tpu_torch.data.train_transforms import TrainPipeline

        return TrainPipeline(cfg)
    return TransformPipeline(cfg, mode)


def normalize_images(images_u8: torch.Tensor,
                     mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """ToTensor + Normalize: (B, H, W, 3) uint8 -> normalised float32 NHWC."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
