"""PyTorch port (simseg_tpu_torch): the subpackages' public tables against
JAX's ``__all__``, and the four public functions that came last
(``utils/metrics.mean_iou`` and ``topk_accuracy``, ``ops/crf.
dense_crf_binary``, ``data/transforms.denormalize_to_u8``) against JAX's on
the CPU.

Bars: the histograms, the top-k ids and the uint8 pixels are integers and
must be equal; the CRF masks agree on >= 99.5% of pixels, the bar of
tests/test_crf_fused.py:62 (both sides order their float32 sums
differently, so a pixel at the threshold may flip).
"""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.data.transforms import denormalize_to_u8 as jax_denormalize
from simseg_tpu.ops.crf import dense_crf_binary as jax_crf_binary
from simseg_tpu.utils.metrics import intersect_and_union as jax_iau
from simseg_tpu.utils.metrics import mean_iou as jax_mean_iou
from simseg_tpu.utils.metrics import topk_accuracy as jax_topk_accuracy
from simseg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, denormalize_to_u8
from simseg_tpu_torch.ops.crf import dense_crf_batched_du, dense_crf_binary
from simseg_tpu_torch.utils.metrics import intersect_and_union, mean_iou, topk_accuracy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ops", "data", "utils", "models", "checkpoint", "engine", "core",
            "parallel")


@pytest.mark.parametrize("name", PACKAGES)
def test_every_jax_public_name_has_a_counterpart_or_a_stated_reason(name):
    jax_pkg = importlib.import_module(f"simseg_tpu.{name}")
    pkg = importlib.import_module(f"simseg_tpu_torch.{name}")
    none = getattr(pkg, "NO_COUNTERPART", ())
    for public in jax_pkg.__all__:
        if public in none:
            assert not hasattr(pkg, public), public
            assert f"``{public}``" in pkg.__doc__, public
            continue
        got = getattr(pkg, public)
        table = getattr(pkg, "_PUBLIC", {})
        if public in table:
            module, attr = table[public]
            assert got is getattr(importlib.import_module(module), attr), public
        assert public in pkg.__all__ and public in dir(pkg), public
    assert set(none) <= set(jax_pkg.__all__)
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")


def test_importing_the_subpackages_imports_no_submodule():
    """Nothing but the packages themselves: no kernel source is built, no
    submodule (nor PIL, yaml or jax) is imported."""
    code = ("import sys, json\n"
            + "".join(f"import simseg_tpu_torch.{p}\n" for p in PACKAGES)
            + "print(json.dumps(sorted(m for m in sys.modules if "
              "m.startswith(('simseg_tpu', 'jax', 'PIL', 'yaml')))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == sorted(["simseg_tpu_torch"] + [
        f"simseg_tpu_torch.{p}" for p in PACKAGES])


def test_utils_logger_is_the_logger_after_its_module_is_imported():
    import simseg_tpu_torch.utils as utils
    from simseg_tpu_torch.utils.logger import Logger, logger

    assert utils.logger is logger and isinstance(logger, Logger)


def label_maps(rng, n, h=37, w=29, num_classes=6):
    preds, labels = [], []
    for i in range(n):
        shape = (h + i, w - i)
        preds.append(rng.integers(0, num_classes + 1, shape))
        label = rng.integers(0, num_classes + 1, shape)
        label[rng.random(shape) < 0.1] = 255
        labels.append(label)
    return preds, labels


@pytest.mark.parametrize("label_map,reduce_zero_label", [
    (None, False), (None, True), ({1: 2, 2: 3}, False),
    (((4, 0), (0, 5)), True), ({6: 255, 3: 1}, False)])
def test_mean_iou_matches_jax(label_map, reduce_zero_label):
    preds, labels = label_maps(np.random.default_rng(0), 4)
    want = jax_mean_iou(preds, labels, 6, 255, label_map, reduce_zero_label)
    got = mean_iou(preds, labels, 6, 255, label_map, reduce_zero_label)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    # one image through the per-image histograms, all four outputs
    lmap = tuple((label_map or {}).items()) if isinstance(label_map, dict) \
        else (label_map or ())
    outs = intersect_and_union(torch.from_numpy(preds[0]),
                               torch.from_numpy(labels[0]), 6, 255, lmap,
                               reduce_zero_label)
    jouts = jax_iau(jnp.asarray(preds[0]), jnp.asarray(labels[0]), 6, 255,
                    lmap, reduce_zero_label)
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_accuracy_matches_jax_with_ties(seed):
    rng = np.random.default_rng(seed)
    # coarse values: many ties, broken toward the lower index by both
    logits = np.round(rng.normal(0, 1, (64, 10)), 1).astype(np.float32)
    logits[:8] = 0.0                        # whole rows tied
    targets = rng.integers(0, 10, 64)
    targets[:8] = np.arange(8)              # tied rows: the first k win
    ks = (1, 2, 3, 5)
    got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), ks)
    want = jax_topk_accuracy(jnp.asarray(logits), jnp.asarray(targets), ks)
    assert [float(g) for g in got] == [float(w) for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    row = topk_accuracy(torch.zeros(1, 4), torch.tensor([1]), (1, 2))
    assert [float(v) for v in row] == [0.0, 1.0]


@pytest.mark.parametrize("stride,dtype", [(4, "auto"), (8, "float32"),
                                          (4, "bfloat16")])
def test_dense_crf_binary_matches_jax(stride, dtype):
    rng = np.random.default_rng(stride)
    k, h, w = 3, 48, 40
    probs = np.clip(rng.uniform(0, 1, (k, 1, 1)) + rng.normal(0, 0.3, (k, h, w)),
                    0.0, 1.0).astype(np.float32)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    kw = dict(bilateral_stride=stride, compute_dtype=dtype)
    got = dense_crf_binary(torch.from_numpy(probs), torch.from_numpy(rgb), **kw)
    assert got.shape == (k, h, w) and got.dtype == torch.int32
    want = np.asarray(jax_crf_binary(jnp.asarray(probs), jnp.asarray(rgb), **kw))
    assert (got.numpy() == want).mean() >= 0.995
    p = np.clip(probs, 0.0, 1.0)
    du = torch.log(torch.from_numpy(p) + 1e-8) - torch.log(
        1.0 - torch.from_numpy(p) + 1e-8)
    np.testing.assert_array_equal(
        got.numpy(), dense_crf_batched_du(du[None], torch.from_numpy(rgb)[None],
                                          **kw)[0].numpy())


def half_way_images():
    """Normalised float32 pixels whose denormalised value is exactly k + 0.5
    in float32 for many k (ties, where the rounding rule shows), beside
    out-of-range ones."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    found = []
    for c in range(3):
        for k in range(-2, 257):
            x0 = np.float32(((k + 0.5) / 255.0 - float(mean[c])) / float(std[c]))
            x = x0
            for _ in range(8):
                y = (np.float32(x) * std[c] + mean[c]) * np.float32(255.0)
                if y == np.float32(k + 0.5):
                    found.append((c, x, min(max(k + k % 2, 0), 255)))
                    break
                x = np.nextafter(x, np.float32(np.inf) if y < k + 0.5
                                 else np.float32(-np.inf))
    images = np.zeros((len(found), 1, 1, 3), np.float32)
    for i, (c, x, _) in enumerate(found):
        images[i, 0, 0, c] = x
    return images, [(c, even) for c, _, even in found]


def test_denormalize_to_u8_matches_jax_half_to_even():
    halves, evens = half_way_images()
    assert len(halves) > 300
    got = denormalize_to_u8(torch.from_numpy(halves))
    # k + 0.5 -> the even one of k and k + 1
    assert [int(got[i, 0, 0, c]) for i, (c, _) in enumerate(evens)] == \
        [even for _, even in evens]
    rng = np.random.default_rng(0)
    images = np.concatenate([halves, rng.normal(0, 2.5, (4, 5, 7, 3)).astype(
        np.float32).reshape(-1, 1, 1, 3)])
    got = denormalize_to_u8(torch.from_numpy(images))
    want = np.asarray(jax_denormalize(jnp.asarray(images)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
