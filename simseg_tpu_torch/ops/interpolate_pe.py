"""Grid resampling: ViT position-embedding interpolation (port of
``simseg_tpu/ops/interpolate_pe.py``) and the bilinear resize of the
multi-scale loop.

Parity: reference ``simseg/utils/interpolate_pe.py:4-27`` — a checkpoint
trained at one resolution (224 px -> 14x14 grid) runs at another (288 px ->
18x18): the patch position embeddings are resampled bicubically on the 2-D
grid and the extra (CLS) rows pass through. As in the JAX version the
resampling is two explicit per-axis matrices built in float64 numpy (cubic
convolution a = -0.75, half-pixel centres, clamped borders: torch's
``upsample_bicubic2d`` with ``align_corners=False``), applied as float32
matmuls, so the result never depends on a backend's bicubic.

``resize_bilinear`` stands for ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: ``F.interpolate(..., antialias=True)``
computes the same triangle filter scaled by the downsampling factor, and is
plain bilinear when upsampling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic convolution kernel, torch's a = -0.75 variant."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a,
                 0.0),
    )


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 matrix M with out = M @ in."""
    scale = in_size / out_size
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(x).astype(np.int64)
    frac = x - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), _cubic_kernel(tap - frac))
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_matrix(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    """``resize_matrix`` on ``device``, kept so a forward copies nothing."""
    return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``_device_matrix``, or a fresh copy while a graph is traced
    (``torch.export``, ``torch.compile``), where it becomes a constant of the
    graph: a cached tensor would keep the tracer's fake one."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)
    return _device_matrix(in_size, out_size, device)


def bicubic_resize_2d(grid: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, new_h, new_w, C) float32, torch-bicubic semantics."""
    _, h, w, _ = grid.shape
    row = _matrix(h, new_h, grid.device)
    col = _matrix(w, new_w, grid.device)
    out = torch.einsum("oh,bhwc->bowc", row, grid.float())
    return torch.einsum("pw,bowc->bopc", col, out)


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """(1, extra + N_old, D) -> (1, extra + N_new, D) in pos_embed's dtype."""
    dim = pos_embed.shape[-1]
    orig_size = int(round((pos_embed.shape[-2] - num_extra_tokens) ** 0.5))
    new_size = int(round(new_num_patches ** 0.5))
    if orig_size == new_size:
        return pos_embed
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(1, orig_size, orig_size, dim)
    grid = bicubic_resize_2d(grid, new_size, new_size)
    grid = grid.reshape(1, new_size * new_size, dim)
    return torch.cat([extra, grid.to(pos_embed.dtype)], dim=1)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) float32, the semantics of
    ``jax.image.resize(x, shape, "bilinear")`` (antialiased downsampling,
    half-pixel centres)."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
