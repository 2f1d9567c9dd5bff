"""PyTorch port (simseg_tpu_torch): the hand-written CUDA kernels against
their plain PyTorch versions, on the card. Imports neither JAX nor
``simseg_tpu``, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

(``--noconftest``: tests/conftest.py configures JAX). Skipped where there is
no CUDA device. Bars, CRF: >= 99.9% mask agreement (a pixel at the
threshold may flip under another f32 summation order); the closing
composition and the zero-iteration threshold are exact. Attention and the
bilateral product: as stated at each test.
"""

import numpy as np
import pytest
import torch

from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention
from simseg_tpu_torch.ops.morphology import closing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the port's kernels)")
    return torch.device("cuda")


def _case(seed, b, k, h, device):
    rng = np.random.default_rng(seed)
    p = np.clip(rng.uniform(0.02, 0.98, (b, k, h, h)), 0.0, 1.0)
    du = (np.log(p + 1e-8) - np.log(1.0 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, h, h, 3)).astype(np.uint8)
    return torch.from_numpy(du).to(device), torch.from_numpy(rgb).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,k,h,stride", [
    (0, 1, 1, 16, 1), (3, 2, 3, 32, 4), (13, 1, 2, 96, 4), (5, 1, 8, 40, 8),
    (21, 2, 5, 288, 8)])
def test_kernel_matches_plain(cuda_device, seed, b, k, h, stride):
    du, rgb = _case(seed, b, k, h, cuda_device)
    for ck in (0, 7):
        before = crf_fused.LAUNCHES
        got = crf_fused.mean_field_fused(du, rgb, stride=stride, closing_ksize=ck)
        assert crf_fused.LAUNCHES == before + 1
        want = crf_fused.mean_field_fused_plain(du, rgb, stride=stride,
                                                closing_ksize=ck)
        assert (got == want).float().mean().item() >= 0.999
    raw = crf_fused.mean_field_fused(du, rgb, stride=stride)
    closed = crf_fused.mean_field_fused(du, rgb, stride=stride, closing_ksize=7)
    assert torch.equal(closing(raw, 7), closed)
    zero = crf_fused.mean_field_fused(du, rgb, stride=stride, num_iters=0)
    assert torch.equal(zero, (du > 0).float())


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    du, rgb = _case(0, 1, 9, 16, cuda_device)
    with pytest.raises(ValueError, match="<= 8"):
        crf_fused.mean_field_fused(du, rgb, stride=4)
    with pytest.raises(ValueError, match="contiguous"):
        crf_fused.mean_field_fused(du[:, :2].transpose(2, 3), rgb, stride=4)
    with pytest.raises(ValueError, match="rgb on"):
        crf_fused.mean_field_fused(du[:, :2], rgb.cpu(), stride=4)


# --------------------------------------------------------------- attention

def _qkv(seed, b, t, h, hd, device):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, hd, generator=gen) for _ in range(3))
    q = q * hd ** -0.5
    return [x.to(device=device, dtype=torch.bfloat16) for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,hd", [
    (1, 64, 64, 1, 64), (2, 200, 200, 2, 128), (1, 1297, 1297, 3, 64),
    (1, 100, 333, 2, 192), (1, 65, 130, 1, 256)])
def test_flash_kernel_matches_plain(cuda_device, b, tq, tk, h, hd):
    """Max abs error <= 2e-2 and mean <= 2e-3 (the kernel divides by the
    softmax sum after its bf16 cast of p, the plain version before)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, _, _ = _qkv(tq, b, tq, h, hd, cuda_device)
    _, k, v = _qkv(tk + 1, b, tk, h, hd, cuda_device)
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_mha(q, k, v)
    assert flash_attention.LAUNCHES == before + 1
    want = flash_attention.flash_mha_plain(q, k, v)
    err = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == (b, tq, h, hd)
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """k and v as views into a fused qkv tensor, as the ViT makes them."""
    qkv = torch.randn(2, 300, 3 * 128, device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.reshape(2, 300, 2, 64) for x in qkv.chunk(3, dim=-1))
    got = flash_attention.flash_mha(q.contiguous() * 0.125, k, v)
    want = flash_attention.flash_mha_plain(q.contiguous() * 0.125, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(0, 1, 64, 1, 32, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_mha(q, k, v)
    q, k, v = _qkv(0, 1, 64, 1, 64, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention.flash_mha(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="must be"):
        flash_attention.flash_mha(q, k[:, :, :, :32], v)


# --------------------------------------------------------------- bilateral

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f,c", [(1, 100, 5, 1), (2, 1100, 5, 5),
                                     (3, 5184, 8, 3), (1, 257, 2, 8)])
def test_bilateral_kernel_matches_plain(cuda_device, b, n, f, c):
    """Relative error max|out - plain| / max|plain| <= 1e-4 (the expanded
    distance cancels; both sides sum it in another order). Features up to
    |f|^2 = 1500, the CRF's own range (colours over srgb = 13)."""
    gen = torch.Generator().manual_seed(n + c)
    feat = torch.rand(b, n, f, generator=gen) * (1500.0 / f) ** 0.5
    feat = feat.to(cuda_device)
    q = torch.randn(b, n, c, generator=gen).to(cuda_device)
    before = crf_pallas.LAUNCHES
    got = crf_pallas.bilateral_matvec_batched(feat, q)
    assert crf_pallas.LAUNCHES == before + 1
    want = crf_pallas.bilateral_matvec_plain(feat, q)
    rel = (got - want).abs().max() / want.abs().max()
    assert got.shape == (b, n, c) and rel.item() <= 1e-4
    one = crf_pallas.bilateral_matvec(feat[0], q[0])
    assert torch.equal(one, got[0])


@pytest.mark.cuda
def test_bilateral_kernel_refuses_what_it_cannot_take(cuda_device):
    feat = torch.zeros(1, 16, 9, device=cuda_device)
    with pytest.raises(ValueError, match="<= 8"):
        crf_pallas.bilateral_matvec_batched(feat, torch.ones(1, 16, 1, device=cuda_device))
    with pytest.raises(ValueError, match="1..8"):
        crf_pallas.bilateral_matvec_batched(feat[..., :5],
                                            torch.ones(1, 16, 9, device=cuda_device))
    with pytest.raises(ValueError, match="q on"):
        crf_pallas.bilateral_matvec_batched(feat[..., :5], torch.ones(1, 16, 1))
