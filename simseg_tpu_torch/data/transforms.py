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
path needs no PIL.

The native decode fast path (JAX ``TransformPipeline._plan_native_head``,
``from_bytes`` and ``load``, :354-500): under ``data.native_decode`` (the
default) both pipelines' ``load`` / ``from_bytes`` fold the leading
geometry op (and a ``random_flip`` right after it) into one call of the
native library (``data/native.py``), drawing their randoms as JAX's plan
does, and run the ops left on the decoded image. The eval pipeline decodes
exactly, the train pipeline with DCT scaling. A head it cannot fold, an
image it cannot take, or no library: the port's reader and the ops, as
JAX falls back to PIL.
"""

from __future__ import annotations

import functools
import math
import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

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


def native_head(names: Sequence[str], cfg) -> Optional[Callable]:
    """JAX's ``_plan_native_head`` (``simseg_tpu/data/transforms.py:
    354-456``): a plan for folding ``names[0]`` (and a ``random_flip`` right
    after it) into one native decode, or None when the head is not
    foldable or ``data.native_decode`` is off. The plan maps (bytes, the
    native module) to (crop or None, (out_w, out_h), filter, ops consumed,
    flip), or to None for an image it cannot take (a crop past the image,
    where PIL pads); its random draws are the PIL ops' own, in their order."""
    if not names or not cfg.get("data", {}).get("native_decode", True):
        return None
    head = names[0]
    t = cfg.transforms

    if head == "resize":
        size = t.resize.size

        def plan(data, native):
            return None, (size, size), native.FILTER_BILINEAR
    elif head == "resize_bicubic":
        size = t.resize_bicubic.size

        def plan(data, native):
            w, h = native.image_size(data)
            if w < h:
                nw, nh = size, int(round(h * size / w))
            else:
                nw, nh = int(round(w * size / h)), size
            return None, (nw, nh), native.FILTER_BICUBIC
    elif head == "center_crop":
        size = t.center_crop.size

        def plan(data, native):
            w, h = native.image_size(data)
            if w < size or h < size:
                return None
            left = int(round((w - size) / 2.0))
            top = int(round((h - size) / 2.0))
            return (left, top, size, size), (size, size), native.FILTER_BILINEAR
    elif head == "random_crop":
        size = t.random_crop.size

        def plan(data, native):
            w, h = native.image_size(data)
            if w < size or h < size:
                return None
            if w == size and h == size:   # the PIL op draws nothing here
                return (0, 0, size, size), (size, size), native.FILTER_BILINEAR
            left = random.randint(0, max(0, w - size))
            top = random.randint(0, max(0, h - size))
            return (left, top, size, size), (size, size), native.FILTER_BILINEAR
    elif head == "random_resize_crop":
        size = t.random_resize_crop.size
        scale = tuple(t.random_resize_crop.scale)
        ratio = (3.0 / 4.0, 4.0 / 3.0)

        def plan(data, native):
            w, h = native.image_size(data)
            area = w * h
            for _ in range(10):
                target = area * random.uniform(*scale)
                logr = random.uniform(np.log(ratio[0]), np.log(ratio[1]))
                ar = float(np.exp(logr))
                cw = int(round((target * ar) ** 0.5))
                ch = int(round((target / ar) ** 0.5))
                if 0 < cw <= w and 0 < ch <= h:
                    left = random.randint(0, w - cw)
                    top = random.randint(0, h - ch)
                    return ((left, top, cw, ch), (size, size),
                            native.FILTER_BILINEAR)
            inr = w / h
            if inr < ratio[0]:
                cw, ch = w, int(round(w / ratio[0]))
            elif inr > ratio[1]:
                cw, ch = int(round(h * ratio[1])), h
            else:
                cw, ch = w, h
            return (((w - cw) // 2, (h - ch) // 2, cw, ch), (size, size),
                    native.FILTER_BILINEAR)
    else:
        return None
    fold_flip = len(names) > 1 and names[1] == "random_flip"

    def planned(data, native):
        p = plan(data, native)
        if p is None:
            return None
        if fold_flip:
            return p + (2, random.random() < 0.5)
        return p + (1, False)

    return planned


def native_decode_head(head, data: bytes, fast_scale: bool):
    """(decoded (H, W, 3) uint8 array, ops consumed) through ``head``, or
    None where the port's reader and every op must run instead: no plan,
    no library, a plan that refuses the image, an encoding it cannot take."""
    if head is None:
        return None
    from simseg_tpu_torch.data import native

    if not native.available():
        return None
    try:
        planned = head(data, native)
        if planned is None:
            return None
        crop, out, filt, consumed, flip = planned
        arr = native.decode(data, crop=crop, out_size=out, flip=flip,
                            filter=filt, fast_scale=fast_scale)
    except ValueError:
        return None
    return arr, consumed


def read_bytes(path: str) -> bytes:
    with open(os.fspath(path), "rb") as f:
        return f.read()


class TransformPipeline:
    """The config's ``valid_transforms`` composed: (H, W, 3) uint8 RGB ->
    uint8, on the image's device (normalisation runs later, on the batch,
    in ``normalize_images``). ``from_bytes`` / ``load`` decode through the
    native head where it folds (exact decode: no DCT scaling)."""

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
        self._head = native_head(self.names, cfg)

    def __call__(self, img: torch.Tensor, start: int = 0) -> torch.Tensor:
        for op in self.ops[start:]:
            img = op(img)
        return img

    def from_bytes(self, data: bytes) -> torch.Tensor:
        """Encoded bytes through the pipeline: a CPU uint8 tensor."""
        done = native_decode_head(self._head, data, fast_scale=False)
        if done is None:
            from simseg_tpu_torch.data.image_io import decode_rgb

            return self(decode_rgb(data, "cpu"))
        arr, consumed = done
        return self(torch.from_numpy(arr), consumed)

    def load(self, path: str) -> torch.Tensor:
        return self.from_bytes(read_bytes(path))


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
