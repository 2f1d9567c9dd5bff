"""Mean-field dense CRF (port of ``simseg_tpu/ops/crf.py:_mean_field_binary``,
``dense_crf_batched``, ``dense_crf_batched_du`` and ``dense_crf_binary``,
with their lane routing).

Parity: the reference refines each candidate class's similarity map with
pydensecrf on the host (``tools/seg_evaluation.py:31-54``): 2-label
DenseCRF2D, Gaussian (sxy=3, compat=3) + bilateral (sxy=40, srgb=13,
compat=10) pairwise terms, 3 mean-field iterations. With two labels and
symmetric kernel normalisation the update depends only on the label
difference ``d = q_fg - q_bg``:

    d' = tanh((du + 3 * G(d) + 10 * B(d)) / 2),   du = log(p) - log(1 - p)

- G: separable truncated Gaussian (sigma 3, radius 9) as two band
  matmuls, normalised by ``rsqrt(blur(ones))`` on both sides;
- B: box-mean splat to the stride-s grid, the symmetric-normalised
  bilateral kernel matrix over its N cells, nearest slice back.

The dense lane is the reference the hand-written kernels
(``ops/crf_fused.py``, ``ops/crf_pallas.py``) are held against, and the
lane every CPU tensor takes unless told otherwise. It computes in float32,
or with ``compute_dtype="bfloat16"`` in bf16 as JAX's bf16 lane does
(fine-grid tensors rounded to bf16 after each step, products summed in
float32). The kernel lanes take bf16 too: ``fused`` runs the mean-field
kernel's bf16 mode, ``stream`` feeds the bilateral kernel float32 and rounds
its products to bf16, as JAX's Pallas lane does
(``simseg_tpu/ops/crf.py:285-300``).
"""

from __future__ import annotations

import numpy as np
import torch

from simseg_tpu_torch.ops.morphology import nearest_upsample


def gaussian_taps(sigma: float, truncate: float = 3.0) -> np.ndarray:
    """Unnormalised Gaussian taps over radius ceil(truncate * sigma), f64."""
    r = int(np.ceil(truncate * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    return np.exp(-(x ** 2) / (2.0 * sigma ** 2))


def band_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """(n, n) float64 B[i, j] = taps[j - i + r], zero outside the band (the
    truncated convolution as a matrix)."""
    k = taps.shape[0]
    d = np.arange(n)[None, :] - np.arange(n)[:, None] + k // 2
    return np.where((d >= 0) & (d < k), taps[np.clip(d, 0, k - 1)], 0.0)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float32 and returned in a's dtype (JAX's einsum with
    ``preferred_element_type=float32`` then ``astype``)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _sep_blur(x: torch.Tensor, band_h: torch.Tensor,
              band_w: torch.Tensor) -> torch.Tensor:
    """Unnormalised separable blur of (..., H, W): rows, then columns."""
    return _mm(band_h.T, _mm(x, band_w))


def box_downsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """(..., H, W) -> (..., H/s, W/s) mean pooling."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // s, s, w // s, s).mean(dim=(-3, -1))


def bilateral_features(rgb_small: torch.Tensor, sxy: float, srgb: float,
                       stride: int) -> torch.Tensor:
    """(B, h, w, 3) stride-s cell colours -> (B, h*w, 5) scaled features:
    cell-centre positions in fine-pixel units over sxy, colours over srgb
    (``simseg_tpu/ops/crf_pallas.py:165-176``)."""
    b, h, w, _ = rgb_small.shape
    dev = rgb_small.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride - 0.5
    pos = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    pos = pos.reshape(1, h * w, 2).expand(b, -1, -1) / sxy
    col = rgb_small.reshape(b, h * w, 3) / srgb
    return torch.cat([pos, col], dim=-1)


def cell_colours(rgb: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, 3) image -> (B, H/s, W/s, 3) box-mean colours, f32."""
    return box_downsample(rgb.float().permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


def bilateral_kernel_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(B, N, F) features -> (B, N, N) K[i, j] = exp(-|f_i - f_j|^2 / 2)."""
    sq = (feat * feat).sum(dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(
        feat, feat.transpose(1, 2))
    return torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def _resolve_bilateral_impl(h: int, w: int, stride: int, on_cuda: bool) -> str:
    """The CRF lane for an (h, w) map at a bilateral stride, chosen as JAX
    ``_resolve_bilateral_impl`` (``simseg_tpu/ops/crf.py:115-132``) chooses
    with ``on_tpu`` read as ``on_cuda``. Lanes (JAX name in brackets):
    - ``"fused"`` (``fused``): the whole mean field in the CUDA kernel of
      ``ops/crf_fused.py``, where ``fused_eligible`` holds;
    - ``"dense"`` (``xla``): the (N, N) kernel matrix materialised once,
      for N <= 4096 cells, and on the CPU;
    - ``"stream"`` (``pallas``): K recomputed on every product by the CUDA
      kernel of ``ops/crf_pallas.py``, for N > 4096.
    """
    if not on_cuda:
        return "dense"
    from simseg_tpu_torch.ops.crf_fused import fused_eligible

    if fused_eligible(h, w, stride):
        return "fused"
    return "dense" if (h // stride) * (w // stride) <= 4096 else "stream"


def dense_crf_batched(probs: torch.Tensor, rgb: torch.Tensor,
                      **kwargs) -> torch.Tensor:
    """Refine K binary probability maps per image: probs (B, K, H, W) in
    [0, 1], rgb (B, H, W, 3) 0..255 -> (B, K, H, W) int32 masks, through
    :func:`dense_crf_batched_du` (its keywords; on a CUDA tensor ``auto``
    takes the kernel lanes)."""
    p = torch.clamp(probs.float(), 0.0, 1.0)
    du = torch.log(p + 1e-8) - torch.log(1.0 - p + 1e-8)
    return dense_crf_batched_du(du, rgb, **kwargs)


def dense_crf_binary(probs: torch.Tensor, rgb: torch.Tensor,
                     **kwargs) -> torch.Tensor:
    """One image: probs (K, H, W), rgb (H, W, 3) -> (K, H, W) int32 masks."""
    return dense_crf_batched(probs[None], rgb[None], **kwargs)[0]


def dense_crf_batched_du(
    du: torch.Tensor,
    rgb: torch.Tensor,
    num_iters: int = 3,
    gaussian_sxy: float = 3.0,
    gaussian_compat: float = 3.0,
    bilateral_sxy: float = 40.0,
    bilateral_srgb: float = 13.0,
    bilateral_compat: float = 10.0,
    bilateral_stride: int = 4,
    bilateral_impl: str = "auto",
    compute_dtype: str = "auto",
) -> torch.Tensor:
    """Refine K binary maps per image from their unary difference.

    du:  (B, K, H, W) float32 ``log(p + 1e-8) - log(1 - p + 1e-8)``.
    rgb: (B, H, W, 3) images, 0..255 scale, any dtype.
    bilateral_impl: ``"auto"`` (``_resolve_bilateral_impl`` on du's device),
    ``"fused"``, ``"dense"`` or ``"stream"``.
    compute_dtype: ``"auto"`` or ``"float32"`` (float32), ``"bfloat16"``
    (bf16, on every lane).
    Returns (B, K, H, W) int32 masks (1 = foreground).
    """
    bb, kk, h, w = du.shape
    s = bilateral_stride
    if h % s or w % s:
        raise ValueError(f"map {h}x{w} not divisible by stride {s}")
    if compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    impl = bilateral_impl
    if impl == "auto":
        impl = _resolve_bilateral_impl(h, w, s, du.device.type == "cuda")
    if impl == "fused":
        from simseg_tpu_torch.ops.crf_fused import mean_field_fused

        return mean_field_fused(
            du.float().contiguous(), rgb, num_iters=num_iters,
            gaussian_sxy=gaussian_sxy, gaussian_compat=gaussian_compat,
            bilateral_sxy=bilateral_sxy, bilateral_srgb=bilateral_srgb,
            bilateral_compat=bilateral_compat, stride=s,
            compute_dtype="bfloat16" if cdt == torch.bfloat16 else "float32",
        ).to(torch.int32)
    if impl not in ("dense", "stream"):
        raise ValueError(f"unknown bilateral_impl {bilateral_impl!r}")
    du = du.float().to(cdt)
    dev = du.device

    taps = gaussian_taps(gaussian_sxy)
    band_h, band_w = (torch.tensor(band_matrix(n, taps), dtype=torch.float32,
                                   device=dev) for n in (h, w))
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    g_norm = torch.rsqrt(_sep_blur(ones, band_h, band_w) + 1e-20).to(cdt)
    band_h, band_w = band_h.to(cdt), band_w.to(cdt)

    n_small = (h // s) * (w // s)
    feat = bilateral_features(cell_colours(rgb, s), bilateral_sxy,
                              bilateral_srgb, s)
    if impl == "stream":
        from simseg_tpu_torch.ops.crf_pallas import bilateral_matvec_batched

        degree = bilateral_matvec_batched(
            feat, torch.ones((bb, n_small, 1), dtype=torch.float32, device=dev))
        b_norm = torch.rsqrt(degree[..., 0] + 1e-20).to(cdt)      # (B, N)

        def bilateral_apply(q: torch.Tensor) -> torch.Tensor:
            # (B, K, N) -> (B, K, N): K (b_norm * q), never stored; the
            # kernel takes float32 and its product is rounded to cdt
            qn = (q * b_norm[:, None, :]).float().transpose(1, 2)
            return bilateral_matvec_batched(feat, qn).transpose(1, 2).to(cdt)
    else:
        kmat = bilateral_kernel_matrix(feat)                       # (B, N, N)
        b_norm = torch.rsqrt(kmat.sum(dim=2) + 1e-20).to(cdt)      # (B, N)
        kmat = kmat.to(cdt)

        def bilateral_apply(q: torch.Tensor) -> torch.Tensor:
            return _mm(q * b_norm[:, None, :], kmat.transpose(1, 2))

    def bilateral_message(d: torch.Tensor) -> torch.Tensor:
        # mean-splat with coarse-degree normalisation is the right
        # discretisation: the fine-grid degree is s^2 (K 1)_c, whose two
        # D^-1/2 factors cancel the s^2 of a sum-splat
        q = box_downsample(d, s).reshape(bb, kk, n_small)
        m = (bilateral_apply(q) * b_norm[:, None, :]).reshape(
            bb, kk, h // s, w // s)
        return nearest_upsample(m, s)

    def gaussian_message(d: torch.Tensor) -> torch.Tensor:
        return _sep_blur(d * g_norm, band_h, band_w) * g_norm

    d = torch.tanh(du * 0.5)
    for _ in range(num_iters):
        m = (gaussian_compat * gaussian_message(d)
             + bilateral_compat * bilateral_message(d))
        d = torch.tanh((du + m) * 0.5)
    return (d > 0).to(torch.int32)
