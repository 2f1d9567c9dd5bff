"""Binary morphology and nearest-neighbour resizing (port of
``simseg_tpu/ops/morphology.py``).

Parity: reference post-CRF cleanup ``tools/seg_evaluation.py:156-161`` —
``cv2.dilate`` then ``cv2.erode`` with a 7x7 ones kernel, then
``cv2.resize(..., INTER_NEAREST)`` to the ground-truth size. Borders behave
like BORDER_CONSTANT of the identity element (dilate pads with -inf, erode
with +inf), so each window runs over valid taps only. Nearest resize uses
cv2's source-index rule ``src = floor(dst * in / out)``.
``binary_closing_matmul`` is the same closing for 0/1 masks as counts from
banded matrix products (JAX ``binary_closing_matmul``, :65).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _window_pass(x: torch.Tensor, ksize: int, dim: int, is_max: bool) -> torch.Tensor:
    """1-D max/min over [v - pad, v + ksize - 1 - pad] along ``dim``."""
    pad = ksize // 2
    fill = float("-inf") if is_max else float("inf")
    widths = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs from the last dim backwards
    widths[2 * (x.ndim - 1 - dim)] = pad
    widths[2 * (x.ndim - 1 - dim) + 1] = ksize - 1 - pad
    xp = F.pad(x, widths, value=fill)
    windows = xp.unfold(dim, ksize, 1)
    return windows.amax(-1) if is_max else windows.amin(-1)


def dilate(x: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Max filter over a ksize x ksize window of float x (..., H, W)."""
    return _window_pass(_window_pass(x, ksize, x.ndim - 1, True), ksize,
                        x.ndim - 2, True)


def erode(x: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Min filter over a ksize x ksize window of float x (..., H, W)."""
    return _window_pass(_window_pass(x, ksize, x.ndim - 1, False), ksize,
                        x.ndim - 2, False)


def closing(x: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """dilate then erode (the reference's cleanup pair)."""
    return erode(dilate(x, ksize), ksize)


def _binary_band(n: int, ksize: int, device, dtype) -> torch.Tensor:
    """(n, n) 0/1 band: B[w, v] = 1 iff w lies in the window of output v,
    [v - pad, v + ksize - 1 - pad] (``_window_pass``'s window)."""
    i = torch.arange(n, device=device)
    d = i[:, None] - i[None, :]
    pad = ksize // 2
    return ((d >= -pad) & (d <= ksize - 1 - pad)).to(dtype)


def binary_closing_matmul(x: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """``closing`` of 0/1-valued x (..., H, W) through band products: a
    window max of 0/1 values is (count > 0), a window min is (count ==
    the window's valid taps), each count one (H, W) x (W, W) product per
    axis. Exact for inputs in {0, 1}: the counts are integers <= ksize,
    exact in bf16 too, so on the card the products take bf16 operands (the
    tensor cores, as JAX's take the MXU); float32 on the CPU. Returns x's
    dtype."""
    *lead, h, w = x.shape
    dot = torch.bfloat16 if x.device.type == "cuda" else torch.float32
    v = x.reshape(-1, h, w).to(dot)
    band_w = _binary_band(w, ksize, x.device, dot)
    band_h = _binary_band(h, ksize, x.device, dot)
    cnt_w, cnt_h = band_w.float().sum(0), band_h.float().sum(0)

    def rows(t):
        return torch.matmul(t, band_w)

    def cols(t):
        return torch.matmul(band_h.T, t)

    v = (rows(v) > 0.5).to(dot)                          # dilate along W
    v = (cols(v) > 0.5).to(dot)                          # dilate along H
    v = (rows(v) >= cnt_w - 0.5).to(dot)                 # erode along W
    v = cols(v) >= cnt_h[:, None] - 0.5                  # erode along H
    return v.to(x.dtype).reshape(*lead, h, w)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsample of (..., H, W) — the semantics of
    ``F.interpolate(scale_factor=f, mode='nearest')``."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def cv2_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """cv2 INTER_NEAREST source indices: floor(dst * in/out), clipped."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest_to_padded(x: torch.Tensor, out_h: torch.Tensor,
                             out_w: torch.Tensor, max_h: int, max_w: int,
                             fill: int = 0) -> torch.Tensor:
    """Nearest-resize an (H, W) map to (out_h, out_w) inside a static
    (max_h, max_w) canvas; pixels beyond (out_h, out_w) get ``fill``.
    out_h/out_w are 0-d integer tensors on x's device (no host sync)."""
    in_h, in_w = x.shape
    oy = torch.arange(max_h, device=x.device)
    ox = torch.arange(max_w, device=x.device)
    sy = torch.clamp(oy * in_h // torch.clamp(out_h, min=1), 0, in_h - 1)
    sx = torch.clamp(ox * in_w // torch.clamp(out_w, min=1), 0, in_w - 1)
    out = x[sy[:, None], sx[None, :]]
    valid = (oy[:, None] < out_h) & (ox[None, :] < out_w)
    return torch.where(valid, out, torch.full_like(out, fill))
