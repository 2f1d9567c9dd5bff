"""PyTorch port (simseg_tpu_torch): the hand-written CUDA kernel against
its plain PyTorch version, on the card. Imports neither JAX nor
``simseg_tpu``, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

(``--noconftest``: tests/conftest.py configures JAX). Skipped where there is
no CUDA device. Bars: >= 99.9% mask agreement (a pixel at the threshold
may flip under another f32 summation order); the closing composition and
the zero-iteration threshold are exact.
"""

import numpy as np
import pytest
import torch

from simseg_tpu_torch.ops import crf_fused
from simseg_tpu_torch.ops.morphology import closing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the CRF kernel)")
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
