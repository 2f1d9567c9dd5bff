"""PyTorch port (simseg_tpu_torch): two faults of the port against the JAX
package, repaired, each with the test that shows it.

- ``SIMSEG_CALIB_IMAGES``: JAX's ``evaluate_benchmark`` calibrates an
  int8_static image tower on that many images
  (``simseg_tpu/tasks/seg_eval.py:399``); the port's now reads it too when
  no ``calib_images`` is given. Bars: both packages calibrate on the same
  8 images, each layer's calibration is JAX's on the same inputs, and the
  per-class IoU is equal.
- MixUpNCE's coefficient: the port's ``mixup_lambda`` is JAX's draw
  (``jax.random.beta`` on the folded step key) computed in numpy. Bar:
  within 1e-6 relative of JAX's over 256 (seed, step) pairs, with and
  without the step key, at three alphas (float32 log / exp / log1p ulps
  move a draw by about 1e-7; no draw here flips a rejection test).
"""

import jax
import numpy as np
import pytest
import torch

import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.engine.train_step import mixup_lambda as jax_mixup_lambda
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.engine.train_step import mixup_lambda, step_key
from simseg_tpu_torch.utils import threefry
from tests.test_torch_port_lanes import CLASSES, WORDS, lane_models  # noqa: F401
from tests.test_torch_port_quant import replayed_calibration_matches_jax

torch.set_num_threads(1)

CALIB = 8


class _Loader:
    """Five batches of 2 at 32 px: calibration takes 4 of them."""

    batch_size = 2

    def __iter__(self):
        for seed in range(5):
            rng = np.random.default_rng(40 + seed)
            yield {"image": rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8),
                   "mask_label": rng.integers(0, len(CLASSES), (2, 40, 48)
                                              ).astype(np.int32),
                   "mask_h": [40] * 2, "mask_w": [48] * 2}


def test_calibration_count_from_the_environment(lane_models, monkeypatch):  # noqa: F811
    flax_model, params, port = lane_models
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4"], target=new_base_cfg())
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", str(CALIB))
    seen = {}

    def recorder(module, key):
        real = module.prepare_quant_params

        def record(*args, **kw):
            seen[key] = np.asarray(torch.as_tensor(kw["calib_images_u8"]))
            return real(*args, **kw)
        monkeypatch.setattr(module, "prepare_quant_params", record)

    recorder(jax_seg_eval, "jax")
    recorder(port_seg_eval, "port")
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        _Loader(), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = replayed_calibration_matches_jax(
        port, lambda: port_seg_eval.evaluate_benchmark(
            _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)),
            CLASSES, 4, "pascal_voc", input_size=32, bilateral_stride=4,
            max_length=12, device="cpu"), 1)
    assert seen["jax"].shape == (CALIB, 32, 32, 3)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou


def test_calibration_keyword_overrides_the_environment(lane_models,  # noqa: F811
                                                       monkeypatch):
    _, _, port = lane_models
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", str(CALIB))
    seen = {}
    real = port_seg_eval.prepare_quant_params

    def record(*args, **kw):
        seen["n"] = kw["calib_images_u8"].shape[0]
        return real(*args, **kw)

    monkeypatch.setattr(port_seg_eval, "prepare_quant_params", record)
    port_seg_eval.evaluate_benchmark(
        _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)), CLASSES,
        4, "pascal_voc", input_size=32, bilateral_stride=4, max_length=12,
        calib_images=3, device="cpu")
    assert seen["n"] == 3


def _pairs(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(s), int(t)) for s, t in zip(rng.integers(0, 2 ** 31, n),
                                              rng.integers(0, 200_000, n))]


@pytest.mark.parametrize("alpha", [0.2, 0.4, 1.0])
def test_mixup_lambda_is_jax_draw(alpha):
    worst = 0.0
    for seed, step in _pairs():
        for stable in (True, False):
            key = jax.random.fold_in(jax.random.key(seed), step) if stable else None
            want = float(jax_mixup_lambda(key, step, alpha))
            got = mixup_lambda(step_key(seed, step) if stable else None, step,
                               alpha)
            assert 0.5 <= got <= 1.0
            worst = max(worst, abs(got - want) / want)
    assert worst <= 1e-6, worst


def test_threefry_keys_and_bits_match_jax():
    """The hash, fold_in, split and the uniform draw bit for bit; the
    normal draw (through log1p) within 1e-6 relative."""
    for seed, step in _pairs(32, seed=1):
        k = jax.random.fold_in(jax.random.key(seed), step)
        ours = threefry.fold_in(threefry.key(seed), step)
        assert tuple(int(v) for v in jax.random.key_data(k)) == ours
        want = [tuple(int(v) for v in r)
                for r in jax.random.key_data(jax.random.split(k, 3))]
        assert threefry.split(ours, 3) == want
        assert threefry.uniform(ours) == np.float32(jax.random.uniform(k))
        np.testing.assert_allclose(threefry.normal(ours),
                                   np.float32(jax.random.normal(k)), rtol=1e-6)
