"""PyTorch port (simseg_tpu_torch): the train-mode transforms against the
JAX package's (``simseg_tpu/data/transforms.py:72-352``), which run PIL
drawing from the module-level ``random`` (erasing's pixels from
``np.random``).

Bar: bit-equal under the same ``random.seed`` / ``np.random.seed``, and the
same number of draws, for every registered train op over image sizes drawn
from 16 to 400 px, for each of AutoAugment's 14 ops at each of its 10
magnitudes, for each of the 24 sub-policies, for ``RandomErasing`` and for
two whole train pipelines (JAX's PIL path, ``data.native_decode=False``).
The eval path still imports no PIL.
"""

import os
import random
import subprocess
import sys
import unittest.mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import simseg_tpu.data.transforms as jax_tf
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data import train_transforms as tt
from simseg_tpu_torch.data.transforms import build_transforms
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ["resize", "resize_bicubic", "center_crop", "random_crop", "random_flip",
       "random_resize_crop", "color_jitter", "gaussian_blur",
       "color_distortion", "autoaug"]
SIZES = dict(resize=72, resize_bicubic=64, center_crop=48, random_crop=56,
             random_resize_crop=60)


def _cfgs(argv):
    argv = list(argv) + ["data.native_decode=False"]
    argv += [f"transforms.{k}.size={v}" for k, v in SIZES.items()]
    return (jax_update_cfg(jax_task_cfg_init_fn, None, argv=argv,
                           target=jax_new_base_cfg()),
            update_cfg(task_cfg_init_fn, None, argv=argv, target=new_base_cfg()))


def _image(seed, h, w):
    """Noise under smooth ramps, so that blur, equalize and the enhancers
    all have something to do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    ramp = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (3 * yy + xx) % 256], -1)
    return np.clip(ramp + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _same_draws(seed, jax_fn, port_fn):
    """Both functions from the same seeds; the outputs as arrays, and the
    generators' states after them."""
    random.seed(seed)
    np.random.seed(seed)
    want = np.asarray(jax_fn())
    state = (random.getstate(), np.random.get_state()[1].tobytes())
    random.seed(seed)
    np.random.seed(seed)
    got = port_fn()
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert (random.getstate(), np.random.get_state()[1].tobytes()) == state
    return got, want


@pytest.mark.parametrize("name", OPS)
@settings(max_examples=12, deadline=None, derandomize=True)
@given(h=st.integers(16, 400), w=st.integers(16, 400), seed=st.integers(0, 2**16))
def test_train_op_matches_jax(name, h, w, seed):
    jcfg, pcfg = _cfgs([])
    jax_op = jax_tf.TRANSFORMS.get(name)(jcfg)
    port_op = tt.TRANSFORMS.get(name)(pcfg)
    img = Image.fromarray(_image(seed, h, w))
    got, want = _same_draws(seed, lambda: jax_op(img), lambda: port_op(img))
    np.testing.assert_array_equal(got, want)


def test_policy_tables_match_jax():
    assert tt.IMAGENET_POLICY == jax_tf._IMAGENET_POLICY
    assert len(tt.IMAGENET_POLICY) == 24
    assert tt.AUG_OPS.keys() == jax_tf._AUG_OPS.keys() and len(tt.AUG_OPS) == 14
    for op, (_, mags) in tt.AUG_OPS.items():
        np.testing.assert_array_equal(mags, jax_tf._AUG_OPS[op][1])


@pytest.mark.parametrize("op", sorted(jax_tf._AUG_OPS))
def test_autoaug_op_matches_jax_at_every_magnitude(op):
    img = Image.fromarray(_image(len(op), 37, 53))
    for level in range(10):
        jax_fn, jax_mags = jax_tf._AUG_OPS[op]
        port_fn, mags = tt.AUG_OPS[op]
        got, want = _same_draws(level, lambda: jax_fn(img, jax_mags[level]),
                                lambda: port_fn(img, mags[level]))
        np.testing.assert_array_equal(got, want, err_msg=f"{op} level {level}")


@pytest.mark.parametrize("index", range(24))
def test_sub_policy_matches_jax(index):
    """Each sub-policy as ``ImageNetPolicy`` draws it (the table cut to that
    entry on both sides), over 6 seeds, so that each op both runs and is
    skipped."""
    policy = tt.IMAGENET_POLICY[index]
    img = Image.fromarray(_image(index, 45, 61))
    with unittest.mock.patch.object(jax_tf, "_IMAGENET_POLICY", [policy]), \
            unittest.mock.patch.object(tt, "IMAGENET_POLICY", [policy]):
        for seed in range(6):
            got, want = _same_draws(seed, lambda: jax_tf.ImageNetPolicy()(img),
                                    lambda: tt.ImageNetPolicy()(img))
            np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("mode", ["pixel", "const"])
@pytest.mark.parametrize("count", [1, 3])
def test_random_erasing_matches_jax(mode, count):
    base = (_image(count, 40, 56) / 255.0).astype(np.float32)
    for seed in range(8):
        got, want = _same_draws(
            seed, lambda: jax_tf.RandomErasing(0.7, mode, count)(base.copy()),
            lambda: tt.RandomErasing(0.7, mode, count)(base.copy()))
        np.testing.assert_array_equal(got, want)


PIPELINES = {
    "simseg.vit-b": ["transforms.train_transforms=[random_resize_crop,autoaug]"],
    "simclr": ["transforms.train_transforms=[random_crop,random_flip,"
               "color_distortion,gaussian_blur]",
               "transforms.random_erasing.reprob=0.5"],
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_train_pipeline_matches_jax(name):
    """The whole pipeline, JAX's on a PIL image and the port's on the
    decoded uint8 tensor: (H, W, 3) uint8 CPU tensors equal to JAX's
    arrays, image after image from one seed."""
    jcfg, pcfg = _cfgs(PIPELINES[name])
    jax_pipe = jax_tf.build_transforms(jcfg, "train")
    port_pipe = build_transforms(pcfg, "train")
    images = [_image(i, 60 + 37 * i, 300 - 41 * i) for i in range(6)]
    got, want = _same_draws(
        3, lambda: np.stack([jax_pipe(Image.fromarray(x)) for x in images]),
        lambda: torch.stack([port_pipe(torch.from_numpy(x)) for x in images]))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_unknown_train_op_raises():
    _, pcfg = _cfgs(["transforms.train_transforms=[random_erasing]"])
    with pytest.raises(NotImplementedError, match="registered ops"):
        build_transforms(pcfg, "train")


def test_valid_mode_imports_no_pil():
    code = ("import sys, torch\n"
            "from simseg_tpu_torch.config import new_base_cfg, update_cfg\n"
            "from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn\n"
            "from simseg_tpu_torch.data.transforms import build_transforms\n"
            "cfg = update_cfg(task_cfg_init_fn, None, argv=["
            "'transforms.valid_transforms=[resize_bicubic,center_crop]'], "
            "target=new_base_cfg())\n"
            "out = build_transforms(cfg, 'valid')(torch.zeros(40, 50, 3, "
            "dtype=torch.uint8))\n"
            "print(tuple(out.shape), 'PIL' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(224,", "224,", "3)", "False"]
