"""Train-mode image transforms on the host (port of
``simseg_tpu/data/transforms.py``: ``random_crop`` :72, ``random_flip`` :86,
``random_resize_crop`` :93-126, ``color_jitter`` :129, ``gaussian_blur``
:142, ``color_distortion`` :157, AutoAugment's ops and ImageNet policy
:177-266, ``RandomErasing`` :272-304, the PIL path of the train
``TransformPipeline`` :307-352).

Why PIL here and not in eval mode: the eval ops are three resamples and a
crop, which ``data/transforms.py`` reproduces bit for bit in integer torch
ops so that they also run on the card. The train ops are AutoAugment's
14 PIL operations (``ImageEnhance``, ``ImageOps``, affine ``transform`` and
``rotate``), blur and colour jitter on the loader's host threads, as in the
JAX package; calling PIL makes them equal to JAX's by construction. This
module owns the composition, the order of the random draws, random erasing
and the conversion to tensors. It needs PIL and fails at import without it;
the eval path does not import it.

Every draw comes from the module-level ``random`` (erasing's pixels from
``np.random``) in JAX's order, so that a seeded single-threaded run gives
JAX's images.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List

import numpy as np
import torch

from simseg_tpu_torch.data.image_io import decode_rgb
from simseg_tpu_torch.data.transforms import (TRANSFORMS, native_decode_head,
                                              native_head, read_bytes)

try:
    from PIL import Image, ImageEnhance, ImageFilter, ImageOps
except ImportError as err:
    raise ImportError("the train-mode transforms (data/train_transforms.py) "
                      "run PIL on the host, and PIL is not installed") from err


# -- geometry -------------------------------------------------------------------

@TRANSFORMS.register
def resize(cfg) -> Callable:
    size = cfg.transforms.resize.size
    return lambda img: img.resize((size, size), Image.BILINEAR)


@TRANSFORMS.register
def resize_bicubic(cfg) -> Callable:
    size = cfg.transforms.resize_bicubic.size

    def fn(img):
        w, h = img.size
        if w < h:
            nw, nh = size, int(round(h * size / w))
        else:
            nw, nh = int(round(w * size / h)), size
        return img.resize((nw, nh), Image.BICUBIC)
    return fn


@TRANSFORMS.register
def center_crop(cfg) -> Callable:
    size = cfg.transforms.center_crop.size

    def fn(img):
        w, h = img.size
        left = int(round((w - size) / 2.0))
        top = int(round((h - size) / 2.0))
        return img.crop((left, top, left + size, top + size))
    return fn


@TRANSFORMS.register
def random_crop(cfg) -> Callable:
    size = cfg.transforms.random_crop.size

    def fn(img):
        w, h = img.size
        if w == size and h == size:
            return img
        left = random.randint(0, max(0, w - size))
        top = random.randint(0, max(0, h - size))
        return img.crop((left, top, left + size, top + size))
    return fn


@TRANSFORMS.register
def random_flip(cfg) -> Callable:
    return lambda img: (
        img.transpose(Image.FLIP_LEFT_RIGHT) if random.random() < 0.5 else img
    )


@TRANSFORMS.register
def random_resize_crop(cfg) -> Callable:
    size = cfg.transforms.random_resize_crop.size
    scale = tuple(cfg.transforms.random_resize_crop.scale)
    ratio = (3.0 / 4.0, 4.0 / 3.0)

    def fn(img):
        w, h = img.size
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
                return img.crop((left, top, left + cw, top + ch)).resize(
                    (size, size), Image.BILINEAR)
        # ten misses: the centre crop at the nearest allowed ratio
        inr = w / h
        if inr < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif inr > ratio[1]:
            cw, ch = int(round(h * ratio[1])), h
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        return img.crop((left, top, left + cw, top + ch)).resize(
            (size, size), Image.BILINEAR)
    return fn


# -- colour ---------------------------------------------------------------------

@TRANSFORMS.register
def color_jitter(cfg) -> Callable:
    strength = float(cfg.transforms.color_jitter)

    def fn(img):
        for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                    ImageEnhance.Color):
            factor = 1.0 + random.uniform(-strength, strength)
            img = enh(img).enhance(max(factor, 0.0))
        return img
    return fn


@TRANSFORMS.register
def gaussian_blur(cfg) -> Callable:
    p = cfg.transforms.gaussian_blur.p
    rmin = cfg.transforms.gaussian_blur.radius_min
    rmax = cfg.transforms.gaussian_blur.radius_max

    def fn(img):
        if random.random() < p:
            return img.filter(
                ImageFilter.GaussianBlur(radius=random.uniform(rmin, rmax)))
        return img
    return fn


@TRANSFORMS.register
def color_distortion(cfg) -> Callable:
    """SimCLR-style strong jitter, then grey with probability 0.2."""
    s = cfg.transforms.color_distortion.strength

    def fn(img):
        if random.random() < 0.8:
            for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                        ImageEnhance.Color):
                img = enh(img).enhance(
                    max(1.0 + random.uniform(-0.8 * s, 0.8 * s), 0.0))
        if random.random() < 0.2:
            img = img.convert("L").convert("RGB")
        return img
    return fn


# -- AutoAugment, the ImageNet policy -------------------------------------------

def _sign() -> int:
    return random.choice([-1, 1])


def _shear_x(img, mag):
    return img.transform(img.size, Image.AFFINE, (1, mag * _sign(), 0, 0, 1, 0))


def _shear_y(img, mag):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, mag * _sign(), 1, 0))


def _translate_x(img, mag):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, mag * img.size[0] * _sign(), 0, 1, 0))


def _translate_y(img, mag):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, 0, 1, mag * img.size[1] * _sign()))


def _rotate(img, mag):
    return img.rotate(mag * _sign())


def _enhance(kind):
    return lambda img, mag: kind(img).enhance(1 + mag * _sign())


# op -> (fn(img, magnitude), the 10 magnitudes a level indexes)
AUG_OPS: Dict[str, tuple] = {
    "shearX": (_shear_x, np.linspace(0, 0.3, 10)),
    "shearY": (_shear_y, np.linspace(0, 0.3, 10)),
    "translateX": (_translate_x, np.linspace(0, 150 / 331, 10)),
    "translateY": (_translate_y, np.linspace(0, 150 / 331, 10)),
    "rotate": (_rotate, np.linspace(0, 30, 10)),
    "color": (_enhance(ImageEnhance.Color), np.linspace(0.0, 0.9, 10)),
    "posterize": (lambda img, m: ImageOps.posterize(img, int(m)),
                  np.round(np.linspace(8, 4, 10), 0).astype(int)),
    "solarize": (lambda img, m: ImageOps.solarize(img, m), np.linspace(256, 0, 10)),
    "contrast": (_enhance(ImageEnhance.Contrast), np.linspace(0.0, 0.9, 10)),
    "sharpness": (_enhance(ImageEnhance.Sharpness), np.linspace(0.0, 0.9, 10)),
    "brightness": (_enhance(ImageEnhance.Brightness), np.linspace(0.0, 0.9, 10)),
    "autocontrast": (lambda img, m: ImageOps.autocontrast(img), [0] * 10),
    "equalize": (lambda img, m: ImageOps.equalize(img), [0] * 10),
    "invert": (lambda img, m: ImageOps.invert(img), [0] * 10),
}

# (op1, p1, level1, op2, p2, level2): the AutoAugment paper's ImageNet
# sub-policies, as the JAX package lists them (24 entries, repeats kept)
IMAGENET_POLICY = [
    ("posterize", 0.4, 8, "rotate", 0.6, 9),
    ("solarize", 0.6, 5, "autocontrast", 0.6, 5),
    ("equalize", 0.8, 8, "equalize", 0.6, 3),
    ("posterize", 0.6, 7, "posterize", 0.6, 6),
    ("equalize", 0.4, 7, "solarize", 0.2, 4),
    ("equalize", 0.4, 4, "rotate", 0.8, 8),
    ("solarize", 0.6, 3, "equalize", 0.6, 7),
    ("posterize", 0.8, 5, "equalize", 1.0, 2),
    ("rotate", 0.2, 3, "solarize", 0.6, 8),
    ("equalize", 0.6, 8, "posterize", 0.4, 6),
    ("rotate", 0.8, 8, "color", 0.4, 0),
    ("rotate", 0.4, 9, "equalize", 0.6, 2),
    ("equalize", 0.0, 7, "equalize", 0.8, 8),
    ("invert", 0.6, 4, "equalize", 1.0, 8),
    ("color", 0.6, 4, "contrast", 1.0, 8),
    ("rotate", 0.8, 8, "color", 1.0, 2),
    ("color", 0.8, 8, "solarize", 0.8, 7),
    ("sharpness", 0.4, 7, "invert", 0.6, 8),
    ("shearX", 0.6, 5, "equalize", 1.0, 9),
    ("color", 0.4, 0, "equalize", 0.6, 3),
    ("equalize", 0.4, 7, "solarize", 0.2, 4),
    ("solarize", 0.6, 5, "autocontrast", 0.6, 5),
    ("invert", 0.6, 4, "equalize", 1.0, 8),
    ("color", 0.6, 4, "contrast", 1.0, 8),
]


def apply_sub_policy(img, policy):
    """One sub-policy: each op with its probability, at its level."""
    op1, p1, m1, op2, p2, m2 = policy
    for op, p, m in ((op1, p1, m1), (op2, p2, m2)):
        if random.random() < p:
            fn, mags = AUG_OPS[op]
            img = fn(img, mags[m])
    return img


class ImageNetPolicy:
    """A sub-policy drawn uniformly per image, then applied."""

    def __call__(self, img):
        return apply_sub_policy(img, random.choice(IMAGENET_POLICY))


@TRANSFORMS.register
def autoaug(cfg) -> Callable:
    return ImageNetPolicy()


# the built-in ops of the registry (a user's ``@TRANSFORMS.register`` op
# may come before or after them)
BUILTIN_OPS = frozenset(n for n in TRANSFORMS
                        if TRANSFORMS.get(n).__module__ == __name__)


# -- random erasing (after the conversion to an array) ---------------------------

class RandomErasing:
    """timm-style cutout on (H, W, C) float arrays in [0, 1]: up to
    ``max_count`` boxes of 2-33% of the area, filled with normal noise
    (``mode='pixel'``) or zeros."""

    def __init__(self, prob: float, mode: str = "pixel", max_count: int = 1):
        self.prob = prob
        self.mode = mode
        self.max_count = max_count

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if random.random() >= self.prob:
            return arr
        h, w, c = arr.shape
        count = random.randint(1, self.max_count)
        for _ in range(count):
            for _attempt in range(10):
                area = h * w * random.uniform(0.02, 1 / 3) / count
                ar = np.exp(random.uniform(np.log(0.3), np.log(1 / 0.3)))
                eh, ew = int(round((area * ar) ** 0.5)), int(round((area / ar) ** 0.5))
                if eh < h and ew < w:
                    top, left = random.randint(0, h - eh), random.randint(0, w - ew)
                    if self.mode == "pixel":
                        arr[top:top + eh, left:left + ew] = np.random.normal(
                            size=(eh, ew, c))
                    else:
                        arr[top:top + eh, left:left + ew] = 0
                    break
        return arr


# -- composition ------------------------------------------------------------------

def to_pil(img):
    """A PIL image as given, or the port's (H, W, 3) uint8 tensor (any
    device) as a PIL RGB image."""
    if isinstance(img, torch.Tensor):
        return Image.fromarray(img.cpu().numpy())
    return img


class TrainPipeline:
    """``cfg.transforms.train_transforms`` composed over PIL, then random
    erasing when ``random_erasing.reprob`` > 0: an image (PIL, or the port's
    uint8 tensor) -> (H, W, 3) uint8 CPU tensor. ``from_bytes`` / ``load``
    decode through the native head where it folds, with DCT scaling, and
    run the PIL ops left (JAX ``TransformPipeline.from_bytes``,
    ``simseg_tpu/data/transforms.py:458-500``)."""

    mode = "train"

    def __init__(self, cfg):
        self.names: List[str] = list(cfg.transforms.train_transforms)
        unknown = [n for n in self.names if n not in TRANSFORMS]
        if unknown:
            raise NotImplementedError(
                f"train transforms {unknown}: the registered ops are "
                f"{sorted(TRANSFORMS)}")
        self.ops: List[Callable] = [TRANSFORMS.get(n)(cfg) for n in self.names]
        self.erasing = None
        re_cfg = cfg.transforms.random_erasing
        if re_cfg.reprob > 0:
            self.erasing = RandomErasing(re_cfg.reprob, re_cfg.remode,
                                         re_cfg.recount)
        self._head = native_head(self.names, cfg)

    def __call__(self, img, start: int = 0) -> torch.Tensor:
        img = to_pil(img)
        for op in self.ops[start:]:
            img = op(img)
        arr = np.array(img.convert("RGB"), dtype=np.uint8)
        if self.erasing is not None:
            arr = (self.erasing(arr.astype(np.float32) / 255.0) * 255
                   ).clip(0, 255).astype(np.uint8)
        return torch.from_numpy(arr)

    def from_bytes(self, data: bytes) -> torch.Tensor:
        """Encoded bytes through the pipeline: a CPU uint8 tensor."""
        done = native_decode_head(self._head, data, fast_scale=True)
        if done is None:
            return self(decode_rgb(data, "cpu"))
        arr, consumed = done
        return self(Image.fromarray(arr), consumed)

    def load(self, path: str) -> torch.Tensor:
        return self.from_bytes(read_bytes(path))
