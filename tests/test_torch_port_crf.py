"""PyTorch port (simseg_tpu_torch): mean-field CRF and morphology, held
against the exact numpy mean field and the JAX package.

On the CPU ``mean_field_fused`` runs its plain version; the JAX side runs
as its own tests run it (the f32 ``xla`` lane, and the Pallas kernel in
interpret mode). Bars: exact at stride 1 (the numpy ground truth);
>= 99.5% mask agreement at coarser strides, the bar of
tests/test_crf_fused.py:62, since both sides order their f32 sums
differently and a pixel at the threshold may flip; morphology, resizing
and the closing composition are 0/1 or integer maps and must be equal.
The kernel itself is held against the plain version on the card by
tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.ops.crf import dense_crf_batched_du as jax_crf_du
from simseg_tpu.ops.crf_fused import _np_constants
from simseg_tpu.ops.crf_fused import mean_field_fused as jax_fused
from simseg_tpu.ops.crf_pallas import bilateral_features as jax_features
from simseg_tpu.ops.morphology import binary_closing_matmul
from simseg_tpu.ops.morphology import closing as jax_closing
from simseg_tpu.ops.morphology import cv2_nearest_indices as jax_cv2_idx
from simseg_tpu.ops.morphology import dilate as jax_dilate
from simseg_tpu.ops.morphology import erode as jax_erode
from simseg_tpu.ops.morphology import nearest_upsample as jax_upsample
from simseg_tpu.ops.morphology import resize_nearest_to_padded as jax_resize
from simseg_tpu_torch.ops.crf import (
    band_matrix,
    bilateral_features,
    cell_colours,
    dense_crf_batched_du,
)
from simseg_tpu_torch.ops.crf_fused import gaussian_constants, mean_field_fused
from simseg_tpu_torch.ops.morphology import (
    closing,
    cv2_nearest_indices,
    dilate,
    erode,
    nearest_upsample,
    resize_nearest_to_padded,
)
from tests.test_crf_morphology import np_dense_crf

torch.set_num_threads(1)


def _du(p):
    p = np.clip(p, 0.0, 1.0)
    return (np.log(p + 1e-8) - np.log(1.0 - p + 1e-8)).astype(np.float32)


def _random_case(seed, b, k, h):
    rng = np.random.default_rng(seed)
    du = _du(rng.uniform(0.02, 0.98, (b, k, h, h)))
    rgb = rng.integers(0, 255, (b, h, h, 3)).astype(np.float32)
    return du, rgb


# ------------------------------------------------------------------- CRF

@pytest.mark.parametrize("seed", [0, 1])
def test_crf_matches_exact_numpy_at_stride1(seed):
    rng = np.random.default_rng(seed)
    h = w = 16
    rgb = np.zeros((h, w, 3))
    rgb[:, : w // 2] = [200, 30, 40]
    rgb[:, w // 2:] = [20, 180, 220]
    rgb += rng.normal(0, 5, rgb.shape)
    probs = np.clip(
        0.5 + 0.35 * np.where(np.arange(w) < w // 2, 1.0, -1.0)[None, :]
        + rng.normal(0, 0.15, (h, w)), 0.01, 0.99)
    want = np_dense_crf(probs, rgb)
    got = mean_field_fused(torch.from_numpy(_du(probs)[None, None]),
                           torch.from_numpy(rgb[None].astype(np.float32)),
                           stride=1)[0, 0].numpy()
    assert (got.astype(np.int64) == want).mean() == 1.0


@pytest.mark.parametrize("seed,b,k,h,stride", [
    (3, 2, 3, 32, 4),
    (13, 1, 2, 96, 4),      # N = 576 cells
    (17, 1, 2, 96, 8),
])
def test_crf_matches_jax_xla_lane(seed, b, k, h, stride):
    du, rgb = _random_case(seed, b, k, h)
    want = np.asarray(jax_crf_du(jnp.asarray(du), jnp.asarray(rgb),
                                 bilateral_stride=stride, bilateral_impl="xla",
                                 compute_dtype="float32"))
    got = mean_field_fused(torch.from_numpy(du), torch.from_numpy(rgb),
                           stride=stride).numpy()
    assert (want == got.astype(np.int32)).mean() >= 0.995
    assert np.array_equal(
        dense_crf_batched_du(torch.from_numpy(du), torch.from_numpy(rgb),
                             bilateral_stride=stride).numpy(),
        got.astype(np.int32))


def _noisy_square():
    """tests/test_crf_morphology.py:test_crf_sharpens_noisy_mask."""
    rng = np.random.default_rng(3)
    gt = np.zeros((32, 32), bool)
    gt[8:24, 8:24] = True
    rgb = np.where(gt[..., None], [210.0, 40.0, 40.0], [30.0, 30.0, 200.0])
    probs = np.clip(gt * 0.8 + 0.1 + rng.normal(0, 0.25, (32, 32)), 0.01, 0.99)
    return probs, rgb, gt


def _ellipse():
    """tests/test_crf_morphology.py:test_crf_stride8_approximates_stride4:
    a structured 96 px scene with a patch-grid probability map."""
    rng = np.random.default_rng(7)
    img = np.zeros((96, 96, 3), np.float32)
    img[:] = [40, 40, 180]
    yy, xx = np.mgrid[0:96, 0:96]
    gt = ((yy - 48) / 28) ** 2 + ((xx - 44) / 32) ** 2 < 1
    img[gt] = [200, 60, 50]
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
    pg = np.clip(0.55 * gt.reshape(6, 16, 6, 16).mean((1, 3)) + 0.25
                 + rng.normal(0, 0.12, (6, 6)), 0.01, 0.99)
    return np.repeat(np.repeat(pg, 16, 0), 16, 1), img, gt


@pytest.mark.parametrize("scene,stride", [
    (_noisy_square, 4), (_ellipse, 4), (_ellipse, 8)])
def test_crf_scenes_match_jax(scene, stride):
    probs, rgb, gt = scene()
    du = _du(probs)[None, None]
    rgb = rgb[None].astype(np.float32)
    want = np.asarray(jax_crf_du(jnp.asarray(du), jnp.asarray(rgb),
                                 bilateral_stride=stride, bilateral_impl="xla",
                                 compute_dtype="float32"))
    got = mean_field_fused(torch.from_numpy(du), torch.from_numpy(rgb),
                           stride=stride).numpy()
    assert (want == got.astype(np.int32)).mean() >= 0.995
    # the CRF cleans the noise inside colour-coherent regions
    assert (got[0, 0].astype(bool) != gt).mean() < ((probs > 0.5) != gt).mean()


def test_crf_matches_jax_fused_kernel_interpret():
    du, rgb = _random_case(3, 2, 3, 32)
    want = np.asarray(jax_fused(jnp.asarray(du), jnp.asarray(rgb), stride=4,
                                closing_ksize=7, compute_dtype=jnp.float32,
                                interpret=True))
    got = mean_field_fused(torch.from_numpy(du), torch.from_numpy(rgb),
                           stride=4, closing_ksize=7).numpy()
    assert (want == got).mean() >= 0.995


def test_closing_inside_equals_closing_of_unclosed_masks():
    du, rgb = _random_case(5, 2, 2, 32)
    du_t, rgb_t = torch.from_numpy(du), torch.from_numpy(rgb)
    raw = mean_field_fused(du_t, rgb_t, stride=4)
    closed = mean_field_fused(du_t, rgb_t, stride=4, closing_ksize=7)
    assert torch.equal(closing(raw, 7), closed)
    want = np.asarray(jax.jit(binary_closing_matmul, static_argnums=1)(
        jnp.asarray(raw.numpy()), 7))
    np.testing.assert_array_equal(closed.numpy(), want)


def test_zero_iterations_is_unary_threshold():
    du, rgb = _random_case(7, 1, 2, 16)
    got = mean_field_fused(torch.from_numpy(du), torch.from_numpy(rgb),
                           num_iters=0, stride=4)
    np.testing.assert_array_equal(got.numpy(), (du > 0).astype(np.float32))


def test_bilateral_features_and_gaussian_constants_match_jax():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 255, (2, 32, 48, 3)).astype(np.uint8)
    small = cell_colours(torch.from_numpy(rgb), 8)
    ours = bilateral_features(small, 40.0, 13.0, 8).numpy()
    for i in range(2):
        want = np.asarray(jax_features(jnp.asarray(small[i].numpy()), 40.0,
                                       13.0, 8))
        np.testing.assert_allclose(ours[i], want, rtol=1e-6, atol=1e-6)
    taps, ah, aw = gaussian_constants(32, 48, 3.0)
    consts = _np_constants(32, 48, 8, 3.0, 7)
    for a, n, key in ((ah, 32, "bandh"), (aw, 48, "bandw")):
        np.testing.assert_allclose(
            a[:, None] * band_matrix(n, taps) * a[None, :], consts[key],
            rtol=1e-12, atol=1e-15)


def test_wrapper_validates_inputs():
    du, rgb = _random_case(0, 1, 2, 16)
    du_t, rgb_t = torch.from_numpy(du), torch.from_numpy(rgb)
    with pytest.raises(ValueError, match="float32"):
        mean_field_fused(du_t.double(), rgb_t, stride=4)
    with pytest.raises(ValueError, match="rgb must be"):
        mean_field_fused(du_t, rgb_t[:, :8], stride=4)
    with pytest.raises(ValueError, match="divisible"):
        mean_field_fused(du_t, rgb_t, stride=5)


# ------------------------------------------------------------ morphology

@pytest.mark.parametrize("shape", [(2, 3, 24, 24), (1, 1, 17, 29)])
@pytest.mark.parametrize("ksize", [7, 3, 4])
def test_morphology_matches_jax(shape, ksize):
    rng = np.random.default_rng(11)
    x = (rng.random(shape) > 0.7).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for ours, ref in ((dilate, jax_dilate), (erode, jax_erode),
                      (closing, jax_closing)):
        np.testing.assert_array_equal(ours(xt, ksize).numpy(),
                                      np.asarray(ref(xj, ksize)))


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 3, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        nearest_upsample(torch.from_numpy(x), 4).numpy(),
        np.asarray(jax_upsample(jnp.asarray(x), 4)))


@pytest.mark.parametrize("out_hw", [(8, 8), (13, 50), (36, 7), (3, 3)])
def test_resize_nearest_to_padded_matches_jax(out_hw):
    src = np.random.default_rng(6).integers(0, 20, (18, 24)).astype(np.int32)
    oh, ow = out_hw
    ours = resize_nearest_to_padded(torch.from_numpy(src), torch.tensor(oh),
                                    torch.tensor(ow), 64, 64, fill=255)
    ref = jax_resize(jnp.asarray(src), jnp.asarray(oh), jnp.asarray(ow), 64, 64,
                     fill=255)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(cv2_nearest_indices(18, oh),
                                  jax_cv2_idx(18, oh))
