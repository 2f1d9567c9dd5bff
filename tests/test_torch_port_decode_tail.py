"""PyTorch port (simseg_tpu_torch): the fused decode tail
(``ops/crf_fused.seg_decode_tail_fused``) and the decode's
``crf_backend="fused_tail"`` lane, held against the JAX package on the CPU.

The JAX tail kernel runs as its own test runs it
(``tests/test_crf_fused.py:112-150``), in interpret mode in float32. Bars:
the plain tail against the JAX kernel, pred and best weight equal on
>= 99.5% of pixels (the bar of the port's CRF tests: the JAX kernel folds
the Gaussian normalisation into its band matrices, so a pixel at the
threshold may flip); against the port's own unfused chain, bit-exact (the
same arithmetic); the ``fused_tail`` decode and the slice, with the bars of
``tests/test_torch_port_seg.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.ops.crf_fused import seg_decode_tail_fused as jax_tail
from simseg_tpu.ops.seg_decode import make_seg_decode_fn as jax_make_decode
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu.tasks.seg_eval import evaluate_benchmark as jax_evaluate
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.ops import crf_fused, seg_decode
from simseg_tpu_torch.ops.crf import dense_crf_batched_du
from simseg_tpu_torch.ops.crf_fused import (seg_decode_tail_fused,
                                            seg_decode_tail_fused_plain)
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample
from simseg_tpu_torch.ops.seg_decode import decode_tail, make_seg_decode_fn
from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark
from tests.test_torch_port_seg import (CASES, CLASSES, PIXEL_BAR, WORDS,
                                       _Loader, slice_models)  # noqa: F401

torch.set_num_threads(1)

# tests/test_crf_fused.py:128-131: an invalid candidate (score 0), a
# negative score and a tie
SCORES = np.array([[0.0, 0.31, 0.31, -0.2],
                   [0.5, 0.0, 0.25, 0.25]], np.float32)
CAND_IDX = np.array([[3, 7, 1, 2], [4, 0, 9, 6]], np.int32)


def _tail_case(seed, b=2, k=4, gh=8):
    """tests/test_crf_fused.py:122-127's inputs: patch-grid unaries and
    0..255 images for a (gh * 4)^2 map."""
    rng = np.random.default_rng(seed)
    du_c = rng.normal(0.0, 3.0, (b, k, gh, gh)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, gh * 4, gh * 4, 3)).astype(np.float32)
    return du_c, rgb


@pytest.mark.parametrize("seed,ck", [(11, 7), (12, 7), (13, 0)])
def test_tail_plain_matches_jax_interpret(seed, ck):
    du_c, rgb = _tail_case(seed)
    kw = dict(du_factor=4, stride=4, closing_ksize=ck)
    jpred, jbw = jax_tail(jnp.asarray(du_c), jnp.asarray(rgb),
                          jnp.asarray(SCORES), jnp.asarray(CAND_IDX),
                          compute_dtype=jnp.float32, interpret=True, **kw)
    pred, bw = seg_decode_tail_fused(
        torch.from_numpy(du_c), torch.from_numpy(rgb),
        torch.from_numpy(SCORES), torch.from_numpy(CAND_IDX), **kw)
    assert pred.dtype == torch.int32 and bw.dtype == torch.float32
    assert pred.shape == bw.shape == (2, 32, 32)
    assert (pred.numpy() == np.asarray(jpred)).mean() >= 0.995
    assert (bw.numpy() == np.asarray(jbw)).mean() >= 0.995


@pytest.mark.parametrize("seed,ck", [(11, 7), (14, 0)])
def test_tail_plain_equals_the_unfused_chain(seed, ck):
    """Upsample, the materialised-K CRF, the closing, then ``decode_tail``
    with the validity mask: the same pred and best weight, bit for bit."""
    du_c, rgb = (torch.from_numpy(x) for x in _tail_case(seed))
    scores = torch.from_numpy(np.abs(SCORES) + 0.1)
    valid = torch.from_numpy(SCORES > 0)
    cand_idx = torch.from_numpy(CAND_IDX).long()
    masks = dense_crf_batched_du(nearest_upsample(du_c, 4), rgb, num_iters=3,
                                 bilateral_stride=4, bilateral_impl="dense")
    if ck:
        masks = closing(masks.float(), ck)
    want = decode_tail(masks.float(), cand_idx, scores, valid)
    got = seg_decode_tail_fused_plain(du_c, rgb, torch.where(valid, scores, 0.0),
                                      cand_idx, 4, stride=4, closing_ksize=ck)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tail_plain_takes_the_dense_lane(monkeypatch):
    """The tail's plain version pins the materialised-K lane, so that on the
    card it never routes back into a kernel."""
    seen = {}

    def record(du, rgb, **kw):
        seen.update(kw)
        return torch.zeros(du.shape, dtype=torch.int32)

    monkeypatch.setattr(crf_fused, "dense_crf_batched_du", record)
    seg_decode_tail_fused_plain(torch.zeros(1, 2, 4, 4), torch.zeros(1, 16, 16, 3),
                                torch.ones(1, 2), torch.zeros(1, 2), 4, stride=4)
    assert seen["bilateral_impl"] == "dense"


# ------------------------------------------------------------- the decode

@pytest.mark.parametrize("name", list(CASES))
def test_fused_tail_decode_matches_jax(name):
    """``crf_backend="fused_tail"`` on the CPU: the JAX decode's default
    branch (its materialised-K lane) and the port's unfused chain agree as
    the auto lanes do, and the port's lane equals its own auto lane."""
    (dense, pooled, tb, raw, _), c, top, cand = CASES[name]
    kw = dict(num_classes=c, image_size=32, patch_size=8, top_cls_num=top,
              candidate_classes=cand, bilateral_stride=4)
    jp, jw = jax.jit(jax_make_decode(**kw, crf_backend="fused_tail"))(
        jnp.asarray(dense), jnp.asarray(pooled), jnp.asarray(tb),
        jnp.asarray(raw))
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in (dense, pooled, tb)] + [torch.from_numpy(raw)]
    pred, best_w = make_seg_decode_fn(**kw, crf_backend="fused_tail")(*args)
    assert pred.dtype == torch.int32 and pred.shape == jp.shape
    same = pred.numpy() == np.asarray(jp)
    assert same.mean() >= PIXEL_BAR
    np.testing.assert_allclose(best_w.numpy()[same], np.asarray(jw)[same],
                               rtol=1e-6, atol=1e-7)
    auto = make_seg_decode_fn(**kw)(*args)
    assert torch.equal(pred, auto[0]) and torch.equal(best_w, auto[1])


@pytest.mark.parametrize("backend", ["stream", "dense", "tail", "Fused"])
def test_unknown_crf_backend_raises(backend):
    """Names outside JAX's set (the CRF-level lane names included)."""
    with pytest.raises(ValueError, match="fused_tail"):
        make_seg_decode_fn(num_classes=4, image_size=32, patch_size=8,
                           crf_backend=backend)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device (the kernel branch of a
    wrapper on a machine without a card)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _scene(b, size, patch, d=16, c=12, seed=0):
    rng = np.random.default_rng(seed)
    grid = size // patch
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    return [torch.from_numpy(a).as_subclass(_CudaLooking) for a in (
        norm(rng.normal(size=(b, grid * grid, d))).astype(np.float32),
        norm(rng.normal(size=(b, d))).astype(np.float32),
        norm(rng.normal(size=(c, d))).astype(np.float32),
        rng.integers(0, 255, (b, size, size, 3)).astype(np.uint8))]


@pytest.mark.parametrize("backend", ["auto", "fused_tail"])
def test_decode_lanes_on_the_card(monkeypatch, backend):
    """On a CUDA tensor at an eligible shape, "fused_tail" hands the
    patch-grid unaries and where(valid, scores, 0) to the tail kernel and
    "auto" the fine unaries to the mean-field kernel; neither reaches the
    other kernel or the plain CRF."""
    calls = []

    def tail(du_coarse, rgb, scores_eff, cand_idx, du_factor, **kw):
        calls.append(("tail", tuple(du_coarse.shape), du_factor, kw,
                      scores_eff.clone()))
        b, _, gh, gw = du_coarse.shape
        return (torch.zeros(b, gh * du_factor, gw * du_factor, dtype=torch.int32),
                torch.zeros(b, gh * du_factor, gw * du_factor))

    def fused(du, rgb, **kw):
        calls.append(("fused", tuple(du.shape)))
        return torch.zeros(du.shape)

    def no_plain(*a, **k):
        raise AssertionError("took the plain CRF")

    monkeypatch.setattr(seg_decode, "seg_decode_tail_fused", tail)
    monkeypatch.setattr(seg_decode, "mean_field_fused", fused)
    monkeypatch.setattr(seg_decode, "dense_crf_batched_du", no_plain)
    dense, pooled, tb, raw = _scene(2, 64, 16)
    decode = make_seg_decode_fn(num_classes=12, image_size=64, patch_size=16,
                                top_cls_num=6, bilateral_stride=8,
                                crf_backend=backend)
    pred, best_w = decode(dense, pooled, tb, raw)
    assert pred.shape == (2, 64, 64)
    if backend == "auto":
        assert calls == [("fused", (2, 5, 64, 64))]
        return
    _, cand_scores, valid = seg_decode.shortlist(
        *(torch.Tensor(x) for x in (pooled, tb)), 6, 5)
    [(name, shape, factor, kw, scores_eff)] = calls
    assert (name, shape, factor) == ("tail", (2, 5, 4, 4), 16)
    assert kw == dict(num_iters=3, stride=8, closing_ksize=7)
    assert torch.equal(torch.Tensor(scores_eff),
                       torch.where(valid, cand_scores, 0.0))


def test_fused_tail_past_the_kernel_takes_the_dense_lane(monkeypatch):
    """Where ``fused_eligible`` fails (N = 1936 cells > 1600) the
    "fused_tail" lane runs the unfused chain on the materialised-K lane,
    as the JAX decode's bilateral_impl="fused_tail" does, on the card
    too."""
    seen = []

    def dense(du, rgb, **kw):
        seen.append(kw["bilateral_impl"])
        return torch.zeros(du.shape, dtype=torch.int32)

    def no_kernel(*a, **k):
        raise AssertionError("took a kernel")

    monkeypatch.setattr(seg_decode, "dense_crf_batched_du", dense)
    monkeypatch.setattr(seg_decode, "seg_decode_tail_fused", no_kernel)
    monkeypatch.setattr(seg_decode, "mean_field_fused", no_kernel)
    decode = make_seg_decode_fn(num_classes=12, image_size=352, patch_size=16,
                                top_cls_num=6, bilateral_stride=8,
                                crf_backend="fused_tail")
    pred, _ = decode(*_scene(1, 352, 16))
    assert seen == ["dense"] and pred.shape == (1, 352, 352)


def _missing_library():
    raise OSError("lib.so: cannot open shared object file")


def test_tail_refuses_cuda_tensor_without_library(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(crf_fused, "_library", _missing_library)
    monkeypatch.setattr(crf_fused, "seg_decode_tail_fused_plain", no_plain)
    du_c = torch.zeros(1, 2, 4, 4).as_subclass(_CudaLooking)
    rgb = torch.zeros(1, 16, 16, 3).as_subclass(_CudaLooking)
    scores = torch.ones(1, 2).as_subclass(_CudaLooking)
    idx = torch.zeros(1, 2, dtype=torch.int32).as_subclass(_CudaLooking)
    before = crf_fused.TAIL_LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        seg_decode_tail_fused(du_c, rgb, scores, idx, 4, stride=4)
    assert crf_fused.TAIL_LAUNCHES == before


# ------------------------------------------------------------------ slice

def test_evaluate_benchmark_fused_tail_matches_jax(slice_models):
    """The slice with ``crf_backend="fused_tail"`` against the JAX
    evaluate_benchmark with ``seg_eval.crf_backend=fused_tail``, on a tiny
    model."""
    _, flax_model, params, port = slice_models
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4", "seg_eval.crf_backend=fused_tail",
    ], target=new_base_cfg())
    jiou, jmiou = jax_evaluate(
        _Loader(), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = evaluate_benchmark(
        _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)), CLASSES,
        4, "pascal_voc", input_size=32, bilateral_stride=4, max_length=12,
        crf_backend="fused_tail", device="cpu")
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou
