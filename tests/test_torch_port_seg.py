"""PyTorch port (simseg_tpu_torch): the segmentation decode and the whole
slice (text bank, towers, decode, mIoU), held against the JAX package on
the same parameters and numpy inputs, on the CPU.

Bars: candidate ids and validity equal; pred agreeing on >= 99.9% of
pixels, the bar the TPU's fused lane met against its xla lane
(docs/ROUND7.md:38), since a CRF pixel at the threshold may flip under a
different f32 summation order; text bank within 1e-5 (f32 towers);
histograms and mIoU equal where pred is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.ops.seg_decode import make_seg_decode_fn as jax_make_decode
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu.tasks.seg_eval import evaluate_benchmark as jax_evaluate
from simseg_tpu.tasks.seg_eval import make_seg_forward as jax_make_forward
from simseg_tpu.tasks.seg_eval import zero_shot_classifier as jax_zero_shot
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn, shortlist
from simseg_tpu_torch.tasks.seg_eval import (
    evaluate_benchmark,
    make_seg_forward,
    zero_shot_classifier,
)
from tests.test_models import tiny_clip
from tests.test_seg_decode import _norm, make_synthetic

torch.set_num_threads(1)

PIXEL_BAR = 0.999


def _jax_shortlist(pooled, text_bank, top_cls_num, candidate_classes):
    """Steps 1-2 of simseg_tpu/ops/seg_decode.py:69-83, as jnp ops."""
    scores = jnp.einsum("bd,cd->bc", pooled, text_bank)
    top_s, top_i = jax.lax.top_k(scores, top_cls_num)
    thr = jnp.mean(top_s, axis=-1) + jnp.std(top_s, axis=-1, ddof=1)
    idx, sc = top_i[:, :candidate_classes], top_s[:, :candidate_classes]
    valid = (idx != 0) & (idx != 255) & (sc >= thr[:, None])
    return np.asarray(idx), np.asarray(valid)


def _random_scene(seed, num_classes=12, grid=4, patch=8, d=16, b=3):
    rng = np.random.default_rng(seed)
    tb = _norm(rng.normal(size=(num_classes, d)))
    dense = _norm(rng.normal(size=(b, grid * grid, d)))
    pooled = _norm(rng.normal(size=(b, d)))
    raw = rng.integers(0, 255, (b, grid * patch, grid * patch, 3)).astype(np.uint8)
    return dense, pooled, tb, raw, None


def _threshold_scene():
    """tests/test_seg_decode.py:test_seg_decode_threshold_semantics: one
    class clears mean + std and owns the left half of the patch grid."""
    rng = np.random.default_rng(2)
    d, c = 16, 10
    tb = _norm(rng.normal(size=(c, d)))
    pooled = _norm(tb[3:4] + 0.05 * rng.normal(size=(1, d)))
    dense = rng.normal(size=(1, 16, d)) * 0.5
    for p in range(16):
        if p % 4 < 2:
            dense[0, p] = tb[3] + rng.normal(0, 0.05, d)
    raw = np.zeros((1, 32, 32, 3), np.uint8)
    raw[:, :, :16] = [200, 50, 50]
    raw[:, :, 16:] = [50, 50, 200]
    return _norm(dense), pooled, tb, raw, None


CASES = {
    # name -> (scene, num_classes, top_cls_num, candidate_classes)
    "recovers_regions": (make_synthetic(0), 16, 10, 3),
    "threshold_semantics": (_threshold_scene(), 10, 5, 3),
    "morphology_seed3": (make_synthetic(3), 16, 10, 3),
    "random_embeddings": (_random_scene(4), 12, 6, 5),
    "random_embeddings_b": (_random_scene(8), 12, 10, 5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax(name):
    (dense, pooled, tb, raw, _), c, top, cand = CASES[name]
    kw = dict(num_classes=c, image_size=32, patch_size=8, top_cls_num=top,
              candidate_classes=cand, bilateral_stride=4)
    jp, jw = jax.jit(jax_make_decode(**kw))(
        jnp.asarray(dense), jnp.asarray(pooled), jnp.asarray(tb),
        jnp.asarray(raw))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pred, best_w = make_seg_decode_fn(**kw)(
        t(dense), t(pooled), t(tb), torch.from_numpy(raw))

    top_n, cand_n = min(top, c), min(cand, top, c)
    idx, _, valid = shortlist(t(pooled), t(tb), top_n, cand_n)
    jidx, jvalid = _jax_shortlist(jnp.asarray(pooled, jnp.float32),
                                  jnp.asarray(tb, jnp.float32), top_n, cand_n)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert pred.dtype == torch.int32 and pred.shape == jp.shape
    assert (pred.numpy() == np.asarray(jp)).mean() >= PIXEL_BAR
    same = pred.numpy() == np.asarray(jp)
    np.testing.assert_allclose(best_w.numpy()[same], np.asarray(jw)[same],
                               rtol=1e-6, atol=1e-7)


def test_decode_background_only_below_threshold():
    """The shortlist winner is background (id 0) and the rest sit below
    mean + std: every pixel is background, as in the JAX decode."""
    rng = np.random.default_rng(1)
    d, c = 16, 8
    tb = _norm(rng.normal(size=(c, d))).astype(np.float32)
    dense = _norm(rng.normal(size=(1, 16, d))).astype(np.float32)
    pooled = _norm(tb[0:1] + rng.normal(0, 0.01, (1, d))).astype(np.float32)
    raw = rng.integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    kw = dict(num_classes=c, image_size=32, patch_size=8, top_cls_num=4,
              candidate_classes=3, bilateral_stride=4)
    pred, _ = make_seg_decode_fn(**kw)(*(torch.from_numpy(a) for a in
                                         (dense, pooled, tb, raw)))
    jp, _ = jax.jit(jax_make_decode(**kw))(*(jnp.asarray(a) for a in
                                             (dense, pooled, tb, raw)))
    assert np.all(pred.numpy() == 0) and np.all(np.asarray(jp) == 0)


def test_decode_tail_first_occurrence_ties():
    """Equal scores on overlapping masks: the earlier candidate wins."""
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    masks = torch.ones(1, 3, 2, 2)
    masks[0, 0, 0, 0] = 0
    cand_idx = torch.tensor([[4, 7, 9]])
    scores = torch.tensor([[0.3, 0.3, 0.3]])
    valid = torch.tensor([[True, True, True]])
    pred, best_w = decode_tail(masks, cand_idx, scores, valid)
    assert pred.tolist() == [[[7, 4], [4, 4]]]
    valid[0, 0] = False
    pred, _ = decode_tail(masks, cand_idx, scores, valid)
    assert pred.tolist() == [[[7, 7], [7, 7]]]


# ------------------------------------------------------------------ slice

WORDS = ["a", "photo", "of", "the", "background", "dog", "cat", "bird",
         "tree", "car"]
CLASSES = ["background", "dog", "cat", "bird", "tree", "car"]


@pytest.fixture(scope="module")
def slice_models():
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4",
    ], target=new_base_cfg())
    flax_model = tiny_clip()
    dummy = {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32),
    }
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0), dummy))
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return cfg, flax_model, params, port.eval()


def test_text_bank_matches_jax(slice_models):
    _, flax_model, params, port = slice_models
    jbank = jax_zero_shot(flax_model, params, CLASSES,
                          JaxWordPiece(jax_make_test_vocab(WORDS)), max_length=12)
    bank = zero_shot_classifier(port, CLASSES,
                                WordPieceTokenizer(make_test_vocab(WORDS)),
                                max_length=12, device="cpu")
    np.testing.assert_allclose(bank.numpy(), jbank, atol=1e-5, rtol=0)


def _batch(seed, b, canvas=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8)
    labels = np.full((b, canvas, canvas), 255, np.int32)
    labels[:, :40, :48] = rng.integers(0, len(CLASSES), (b, 40, 48))
    return images, labels


def test_seg_forward_matches_jax(slice_models):
    cfg, flax_model, params, port = slice_models
    rng = np.random.default_rng(0)
    tb = _norm(rng.normal(size=(len(CLASSES), 16))).astype(np.float32)
    images, labels = _batch(0, 2)
    gt_h, gt_w = np.array([40, 33]), np.array([48, 29])
    ji, ju, jpred = jax.jit(jax_make_forward(
        flax_model, cfg, num_classes=6, top_cls_num=4, canvas=64, patch_size=8,
        return_pred=True))(params, jnp.asarray(images), jnp.asarray(tb),
                           jnp.asarray(labels), jnp.asarray(gt_h),
                           jnp.asarray(gt_w))
    fwd = make_seg_forward(port, num_classes=6, top_cls_num=4, canvas=64,
                           input_size=32, bilateral_stride=4, return_pred=True,
                           device="cpu")
    i, u, pred = fwd(torch.from_numpy(images), torch.from_numpy(tb),
                     torch.from_numpy(labels), torch.from_numpy(gt_h),
                     torch.from_numpy(gt_w))
    assert (pred.numpy() == np.asarray(jpred)).mean() >= PIXEL_BAR
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


class _Loader:
    """Two batches of 2, the second ragged (1 image)."""

    batch_size = 2

    def __iter__(self):
        for seed, b in ((1, 2), (2, 1)):
            images, labels = _batch(seed, b, canvas=48)
            yield {"image": images, "mask_label": labels[:, :40, :48],
                   "mask_h": [40] * b, "mask_w": [48] * b}


def test_evaluate_benchmark_matches_jax(slice_models):
    cfg, flax_model, params, port = slice_models
    jiou, jmiou = jax_evaluate(
        _Loader(), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = evaluate_benchmark(
        _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)), CLASSES,
        4, "pascal_voc", input_size=32, bilateral_stride=4, max_length=12,
        device="cpu")
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou
