"""PyTorch port (simseg_tpu_torch): the accelerated inference lanes end to
end — ``evaluate_benchmark`` with token merging and int8_static towers,
calibration included, against the JAX package's ``evaluate_benchmark``
(the counterpart of ``tests/test_seg_eval_task.py``'s int8_static case),
and the label banks against JAX's ``load_label_bank``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.checkpoint.convert import (flax_params_to_state_dict,
                                                 flax_quant_to_buffers)
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops import quant
from tests.test_models import tiny_clip
from tests.test_torch_port_quant import replayed_calibration_matches_jax

torch.set_num_threads(1)

WORDS = ["a", "photo", "of", "the", "background", "dog", "cat", "bird",
         "tree", "car"]
CLASSES = ["background", "dog", "cat", "bird", "tree", "car"]
ARCH = dict(image_arch=(("tome_r", 2), ("quant", "int8_static")),
            text_arch=(("quant", "int8_static"),))


class _Loader:
    """Three batches of 2, the last ragged (1 image)."""

    batch_size = 2

    def __iter__(self):
        for seed, b in ((1, 2), (2, 2), (3, 1)):
            rng = np.random.default_rng(seed)
            images = rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8)
            labels = rng.integers(0, len(CLASSES), (b, 40, 48)).astype(np.int32)
            yield {"image": images, "mask_label": labels,
                   "mask_h": [40] * b, "mask_w": [48] * b}


@pytest.fixture(scope="module")
def lane_models():
    flax_model = tiny_clip(**ARCH)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, 12), jnp.int32),
             "attention_mask": jnp.ones((1, 12), jnp.int32)}
    params = jax.tree.map(np.asarray, jax.jit(flax_model.init)(
        jax.random.key(0), dummy))
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3, **ARCH)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port.eval()


def test_evaluate_benchmark_tome_int8_static_matches_jax(lane_models,
                                                         monkeypatch):
    """Calibration on the first 3 images (the first batch and one of the
    second: JAX's ``SIMSEG_CALIB_IMAGES``, the port's ``calib_images``) and
    on the prompt bank, then the evaluation: each layer's calibration is
    JAX's on the same inputs, and the per-class IoU equals JAX's."""
    flax_model, params, port = lane_models
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4"], target=new_base_cfg())
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", "3")
    seen = {}
    real = jax_seg_eval.prepare_quant_params

    def record(*args, **kw):
        seen["vars"] = real(*args, **kw)
        seen["calib"] = np.asarray(kw["calib_images_u8"])
        return seen["vars"]

    monkeypatch.setattr(jax_seg_eval, "prepare_quant_params", record)
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        _Loader(), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = replayed_calibration_matches_jax(
        port, lambda: port_seg_eval.evaluate_benchmark(
            _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)),
            CLASSES, 4, "pascal_voc", input_size=32, bilateral_stride=4,
            max_length=12, calib_images=3, device="cpu"), 1)
    assert seen["calib"].shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou
    # each package's own calibration: the same layers, and the same state
    # up to the ulp-level divergence replayed_calibration_matches_jax
    # describes: floats within one int8 step of an upstream layer (1/127)
    # and codes within one step, on at least 99% of entries equal
    want = flax_quant_to_buffers(jax.tree.map(np.asarray, seen["vars"]["quant"]))
    layers = quant.quant_layers(port)
    assert len(want) == 3 * len(layers) == 3 * (4 * 2 + 6 * 2)
    for key, ref in want.items():
        name, buffer = key.rsplit(".", 1)
        got = getattr(layers[name], buffer)
        if ref.dtype == torch.int8:
            step = (got.int() - ref.int()).abs()
            assert step.max() <= 1 and (step > 0).float().mean() <= 1e-2, key
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       rtol=1 / 127, atol=0, err_msg=key)


def test_evaluate_benchmark_refuses_a_one_shot_iterator(lane_models):
    _, _, port = lane_models
    with pytest.raises(ValueError, match="re-iterable"):
        port_seg_eval.evaluate_benchmark(
            iter(_Loader()), port, WordPieceTokenizer(make_test_vocab(WORDS)),
            CLASSES, 4, "pascal_voc", input_size=32, max_length=12,
            device="cpu")


@pytest.mark.parametrize("name", ["pascal_voc", "pascal_context", "coco_stuff"])
def test_label_banks_match_jax(name, tmp_path):
    """Every packaged bank equals JAX's (the port used to raise for
    pascal_context and coco_stuff: it shipped only pascal_voc), found
    through a data_root without banks and through one with its own copy."""
    nowhere = str(tmp_path / "empty")
    want = jax_seg_eval.load_label_bank(name, nowhere)
    assert port_seg_eval.load_label_bank(name, nowhere) == want
    assert port_seg_eval.load_label_bank(name) == jax_seg_eval.load_label_bank(name)
    custom = tmp_path / "root" / "label_category"
    custom.mkdir(parents=True)
    (custom / f"{name}.txt").write_text("sky\nroad\n\nsea\n")
    root = str(tmp_path / "root")
    assert port_seg_eval.load_label_bank(name, root) == ["sky", "road", "sea"]
    assert jax_seg_eval.load_label_bank(name, root) == ["sky", "road", "sea"]
