"""PyTorch port (simseg_tpu_torch): the eval transforms against the JAX
package's ``build_transforms(cfg, "valid")``, which runs PIL's ops
(``simseg_tpu/data/transforms.py:40-69, :307-352``).

Bar: bit-equal, over image and target sizes drawn from 1 to 800 px, up
and down, for ``resize`` (PIL bilinear), ``resize_bicubic`` (shorter side
to the size, PIL bicubic), ``center_crop`` (PIL's zero fill where the crop
leaves the image) and their compositions. A random op in the valid
pipeline raises (the train mode is tests/test_torch_port_train_transforms.py).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.data.transforms import build_transforms as jax_build_transforms
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.transforms import (build_transforms, pil_resize,
                                              resample_coefficients)
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

torch.set_num_threads(1)

PIPELINES = [["resize"], ["resize_bicubic"], ["center_crop"],
             ["resize_bicubic", "center_crop"], ["resize", "center_crop"]]
N_SIZES = 24


def _cfgs(ops, size, crop):
    argv = [f"transforms.valid_transforms={ops!r}",
            f"transforms.resize.size={size}",
            f"transforms.resize_bicubic.size={size}",
            f"transforms.center_crop.size={crop}"]
    return (jax_update_cfg(jax_task_cfg_init_fn, None, argv=argv,
                           target=jax_new_base_cfg()),
            update_cfg(task_cfg_init_fn, None, argv=argv, target=new_base_cfg()))


def _image(rng, h, w):
    """Half the draws noise, half smooth ramps (the rounding of both)."""
    if rng.random() < 0.5:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (3 * yy + xx) % 256], -1).astype(np.uint8)


@pytest.mark.parametrize("ops", PIPELINES, ids="+".join)
def test_valid_pipeline_matches_jax(ops):
    rng = np.random.default_rng(len(ops) * 7 + len(ops[0]))
    for _ in range(N_SIZES):
        h, w = (int(v) for v in rng.integers(1, 801, 2))
        size, crop = (int(v) for v in rng.integers(1, 801, 2))
        jax_tf = jax_build_transforms(_cfgs(ops, size, crop)[0], "valid")
        port_tf = build_transforms(_cfgs(ops, size, crop)[1], "valid")
        img = _image(rng, h, w)
        want = jax_tf(Image.fromarray(img))
        got = port_tf(torch.from_numpy(img))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{ops} {(h, w)} {size} {crop}")


@pytest.mark.parametrize("kind,pil", [("bilinear", Image.BILINEAR),
                                      ("bicubic", Image.BICUBIC)])
def test_resize_matches_pil_to_any_shape(kind, pil):
    """Non-square targets, each side up or down on its own, 1-px edges."""
    rng = np.random.default_rng(11)
    shapes = [((1, 1), (5, 3)), ((7, 800), (1, 1)), ((375, 500), (288, 288)),
              ((500, 333), (288, 288)), ((2, 3), (800, 1))]
    shapes += [(tuple(int(v) for v in rng.integers(1, 801, 2)),
                tuple(int(v) for v in rng.integers(1, 801, 2)))
               for _ in range(N_SIZES)]
    for (h, w), (oh, ow) in shapes:
        img = _image(rng, h, w)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), pil))
        got = pil_resize(torch.from_numpy(img), (ow, oh), kind).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)}->{(oh, ow)}")


def test_coefficients_are_fixed_point_and_normalised():
    """Each output's 22-bit weights sum to 2^22 within the rounding of its
    taps, and its taps stay inside the image."""
    for n_in, n_out in ((500, 288), (288, 500), (7, 3), (1, 9)):
        for kind in ("bilinear", "bicubic"):
            index, weight = resample_coefficients(n_in, n_out, kind)
            assert index.min() >= 0 and index.max() < n_in
            taps = (weight != 0).sum(1)
            assert np.all(np.abs(weight.sum(1) - (1 << 22)) <= taps)


def test_train_mode_and_unported_ops_raise():
    """Train mode builds (over PIL); the valid pipeline takes the three
    deterministic ops only, and an unknown mode raises."""
    cfg = _cfgs(["resize"], 32, 16)[1]
    assert build_transforms(cfg, "train").mode == "train"
    for ops in (["random_erasing"], ["resize", "autoaug"]):
        cfg = _cfgs(ops, 32, 16)[1]
        with pytest.raises(NotImplementedError, match="PIL-free"):
            build_transforms(cfg, "valid")
    with pytest.raises(ValueError, match="mode"):
        build_transforms(cfg, "test")
