"""PyTorch port (simseg_tpu_torch): the streaming bilateral product's plain
version, the CRF's streaming lane and the lane routing, held against the
JAX package on the CPU.

The JAX kernel runs as its own tests run it, in interpret mode. Bars: the
products within rtol 1e-4 (an entry whose sum cancels is held to 1e-4 of
the column's largest entry instead). Both sides compute the expanded
float32 distance |f_i|^2 + |f_j|^2 - 2 f_i.f_j, which cancels: at
|f|^2 ~ 1.2e3 (colours over srgb = 13) the two dot products of one pair,
summed in different orders, differ by up to 1.2e-4, so d2 differs by up to
2.4e-4 and every K entry by up to 1.2e-4 relative — a 1e-5 bar is not
reachable by any second implementation of that form, measured worst here
is 6e-5; the streaming CRF exact at stride 1 and on >= 99.5% of
mask pixels at stride 4 (tests/test_torch_port_crf.py); routing equal.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.ops.crf import _resolve_bilateral_impl as jax_resolve
from simseg_tpu.ops.crf import dense_crf_batched_du as jax_crf_du
from simseg_tpu.ops.crf_fused import fused_eligible as jax_fused_eligible
from simseg_tpu.ops.crf_pallas import bilateral_features as jax_features
from simseg_tpu.ops.crf_pallas import bilateral_matvec as jax_matvec
from simseg_tpu.ops.crf_pallas import bilateral_matvec_batched as jax_matvec_batched
from simseg_tpu_torch.ops import crf_fused, crf_pallas
from simseg_tpu_torch.ops.crf import (
    _resolve_bilateral_impl,
    bilateral_features,
    dense_crf_batched_du,
)
from simseg_tpu_torch.ops.crf_fused import fused_eligible

torch.set_num_threads(1)


def _features(seed, b, h, w, stride=8):
    """(B, h*w, 5) bilateral features of random cell colours, as the CRF
    builds them (positions over sxy = 40, colours over srgb = 13)."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    feat = bilateral_features(torch.from_numpy(rgb), 40.0, 13.0, stride)
    ref = np.stack([np.asarray(jax_features(jnp.asarray(r), 40.0, 13.0, stride))
                    for r in rgb])
    np.testing.assert_allclose(feat.numpy(), ref, rtol=1e-6)
    return feat.numpy()


def _close(ours, ref):
    scale = np.abs(ref).max(axis=-2, keepdims=True)
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), scale)
    assert rel.max() <= 1e-4, rel.max()


@pytest.mark.parametrize("n_hw,c", list(itertools.product(
    [(20, 30), (25, 44)], [1, 5])))
def test_plain_matvec_matches_jax_interpret(n_hw, c):
    """N = 600 and 1100: both pad to a multiple of 512 on the TPU side."""
    h, w = n_hw
    feat = _features(h * w + c, 2, h, w)
    rng = np.random.default_rng(c)
    q = rng.normal(size=(2, h * w, c)).astype(np.float32)
    if c == 1:
        q = np.ones_like(q)  # the degree column
    ours = crf_pallas.bilateral_matvec_batched(torch.from_numpy(feat),
                                               torch.from_numpy(q)).numpy()
    ref = np.asarray(jax_matvec_batched(jnp.asarray(feat), jnp.asarray(q),
                                        interpret=True))
    _close(ours, ref)
    one = crf_pallas.bilateral_matvec(torch.from_numpy(feat[1]),
                                      torch.from_numpy(q[1])).numpy()
    _close(one, np.asarray(jax_matvec(jnp.asarray(feat[1]), jnp.asarray(q[1]),
                                      interpret=True)))


def test_plain_matvec_row_tiles_equal_one_product():
    """The plain version's 512-row tiling changes nothing."""
    feat = torch.from_numpy(_features(3, 1, 40, 30))
    q = torch.randn(1, 1200, 3)
    sq = (feat * feat).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * feat @ feat.transpose(1, 2)
    want = torch.exp(-0.5 * d2.clamp(min=0)) @ q
    np.testing.assert_allclose(crf_pallas.bilateral_matvec_plain(feat, q),
                               want, rtol=1e-6, atol=1e-6)


def _du_case(seed, b, k, h):
    rng = np.random.default_rng(seed)
    p = np.clip(rng.uniform(0.02, 0.98, (b, k, h, h)), 0.0, 1.0)
    du = (np.log(p + 1e-8) - np.log(1.0 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, h, h, 3)).astype(np.float32)
    return du, rgb


@pytest.mark.parametrize("seed,b,k,h,stride,bar", [
    (0, 1, 2, 16, 1, 1.0), (1, 2, 3, 32, 4, 0.995), (2, 1, 5, 48, 4, 0.995)])
def test_streaming_crf_lane_matches_jax(seed, b, k, h, stride, bar):
    du, rgb = _du_case(seed, b, k, h)
    ours = dense_crf_batched_du(torch.from_numpy(du), torch.from_numpy(rgb),
                                bilateral_stride=stride,
                                bilateral_impl="stream").numpy()
    ref = np.asarray(jax_crf_du(jnp.asarray(du), jnp.asarray(rgb),
                                bilateral_stride=stride, bilateral_impl="xla",
                                compute_dtype="float32"))
    assert ours.dtype == np.int32
    assert (ours == ref).mean() >= bar


_LANES = {"fused": "fused", "xla": "dense", "pallas": "stream"}


@pytest.mark.parametrize("size,stride", list(itertools.product(
    [288, 320, 448, 512, 576], [4, 8])))
def test_lane_routing_matches_jax(size, stride):
    assert fused_eligible(size, size, stride) == jax_fused_eligible(
        size, size, stride)
    for on_device in (True, False):
        assert _resolve_bilateral_impl(size, size, stride, on_device) == \
            _LANES[jax_resolve("auto", size, size, stride, on_device)]


def test_fused_plain_version_takes_the_dense_lane(monkeypatch):
    """The fused kernel's plain version pins the materialised-K lane, so
    that on the card it never routes back into a kernel."""
    seen = {}

    def record(du, rgb, **kw):
        seen.update(kw)
        return torch.zeros(du.shape, dtype=torch.int32)

    monkeypatch.setattr(crf_fused, "dense_crf_batched_du", record)
    crf_fused.mean_field_fused_plain(torch.zeros(1, 2, 16, 16),
                                     torch.zeros(1, 16, 16, 3), stride=4)
    assert seen["bilateral_impl"] == "dense"
