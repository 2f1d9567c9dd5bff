"""PyTorch port (simseg_tpu_torch): every knob of the decode that JAX's
``make_seg_decode_fn`` takes (``crf_backend`` x ``morphology_impl`` x
``compute_dtype``, ``simseg_tpu/ops/seg_decode.py:36-223``), against JAX's
decode on the CPU on the same numpy inputs.

JAX's kernel lanes run as its own tests run them on the CPU: the Pallas
kernels in interpret mode (``tests/test_crf_pallas.py``,
``tests/test_crf_fused.py``). The port's kernel lanes run their plain
versions on a CPU tensor. Bars: pred equal on >= 99.9% of pixels in
float32 (a CRF pixel at the threshold may flip under another summation
order) and >= 99% in bf16 against JAX's bf16 decode (bf16 rounds at other
places in the two frameworks; on the CPU JAX's ``fused_tail`` runs its
unfused chain, the port's the tail's bf16 plain version). A second group
checks the routing on the card, with the kernels and the plain CRF
replaced by recorders on CPU tensors that report a CUDA device: bf16 on a
kernel lane reaches that kernel's bf16 mode.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.ops.crf_fused as jax_crf_fused
import simseg_tpu.ops.crf_pallas as jax_crf_pallas
from simseg_tpu.ops.morphology import binary_closing_matmul as jax_closing_mm
from simseg_tpu.ops.seg_decode import make_seg_decode_fn as jax_make_decode
from simseg_tpu_torch.ops import seg_decode
from simseg_tpu_torch.ops.morphology import binary_closing_matmul, closing
from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
from tests.test_seg_decode import make_synthetic
from tests.test_torch_port_decode_tail import _scene

torch.set_num_threads(1)

BACKENDS = ("auto", "xla", "pallas", "fused", "fused_tail")
MORPHOLOGY = ("auto", "window", "matmul")
DTYPES = ("auto", "float32", "bfloat16")
KERNEL_LANES = ("pallas", "fused", "fused_tail")
F32_BAR = 0.999
BF16_BAR = 0.99
KW = dict(num_classes=16, image_size=32, patch_size=8, top_cls_num=10,
          candidate_classes=3, bilateral_stride=4)


@pytest.fixture(scope="module")
def scenes():
    """Two synthetic scenes of two class regions each (the JAX decode
    test's), and a noisy one whose masks have ragged edges."""
    out = []
    for seed in (0, 5):
        dense, pooled, tb, raw, _ = make_synthetic(seed=seed)
        if seed == 5:
            rng = np.random.default_rng(seed)
            raw = rng.integers(0, 255, raw.shape).astype(np.uint8)
            dense = dense + rng.normal(0, 0.3, dense.shape)
            dense /= np.linalg.norm(dense, axis=-1, keepdims=True)
        out.append(tuple(a.astype(np.float32) if a.dtype != np.uint8 else a
                         for a in (dense, pooled, tb, raw)))
    return out


@pytest.fixture(scope="module")
def interpret_kernels():
    """JAX's Pallas kernels in interpret mode on the CPU, for this module."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_crf_pallas, "bilateral_matvec_batched", functools.partial(
        jax_crf_pallas.bilateral_matvec_batched, interpret=True))
    patch.setattr(jax_crf_fused, "mean_field_fused", functools.partial(
        jax_crf_fused.mean_field_fused, interpret=True))
    yield
    patch.undo()


CASES = list(itertools.product(BACKENDS, MORPHOLOGY, DTYPES))


@pytest.mark.parametrize("backend,morph,dtype", CASES)
def test_decode_knobs_match_jax(scenes, interpret_kernels, backend, morph,
                                dtype):
    knobs = dict(crf_backend=backend, morphology_impl=morph,
                 compute_dtype=dtype)
    jdecode = jax.jit(jax_make_decode(**KW, **knobs))
    decode = make_seg_decode_fn(**KW, **knobs)
    same = total = 0
    for args in scenes:
        jpred, _ = jdecode(*(jnp.asarray(a) for a in args))
        pred, best_w = decode(*(torch.from_numpy(a) for a in args))
        assert pred.dtype == torch.int32 and best_w.dtype == torch.float32
        same += int((pred.numpy() == np.asarray(jpred)).sum())
        total += pred.numel()
    assert same / total >= (BF16_BAR if dtype == "bfloat16" else F32_BAR), \
        same / total


def _dtype_recorders(monkeypatch):
    """Recorders of the compute dtype each kernel entry (and the plain
    CRF's) receives on the card."""
    seen = []

    def tail(du_coarse, rgb, scores_eff, cand_idx, du_factor, **kw):
        seen.append(("tail", kw["compute_dtype"]))
        b, _, gh, gw = du_coarse.shape
        return (torch.zeros(b, gh * du_factor, gw * du_factor, dtype=torch.int32),
                torch.zeros(b, gh * du_factor, gw * du_factor))

    def fused(du, rgb, **kw):
        seen.append(("fused", kw["compute_dtype"]))
        return torch.zeros(du.shape, dtype=torch.bfloat16)

    def crf(du, rgb, **kw):
        seen.append((kw["bilateral_impl"], kw["compute_dtype"]))
        return torch.zeros(du.shape, dtype=torch.int32)

    monkeypatch.setattr(seg_decode, "seg_decode_tail_fused", tail)
    monkeypatch.setattr(seg_decode, "mean_field_fused", fused)
    monkeypatch.setattr(seg_decode, "dense_crf_batched_du", crf)
    return seen


@pytest.mark.parametrize("backend,morph", list(itertools.product(
    KERNEL_LANES, MORPHOLOGY)))
def test_bf16_on_a_kernel_lane_runs_its_bf16_mode(monkeypatch, backend, morph):
    """On the card, bf16 on a kernel lane reaches that lane's kernel entry
    with ``compute_dtype="bfloat16"`` (``pallas`` and ``fused`` through the
    CRF entry, whose lanes run the bilateral kernel on float32 operands and
    the mean-field kernel's bf16 mode), and the masks reach the closing."""
    seen = _dtype_recorders(monkeypatch)
    decode = make_seg_decode_fn(num_classes=12, image_size=64, patch_size=16,
                                top_cls_num=6, bilateral_stride=8,
                                crf_backend=backend, morphology_impl=morph,
                                compute_dtype="bfloat16")
    pred, _ = decode(*_scene(2, 64, 16))
    assert pred.shape == (2, 64, 64)
    lane = {"pallas": "stream", "fused": "fused", "fused_tail": "tail"}[backend]
    assert seen == [(lane, "bfloat16")]


def test_bf16_auto_takes_the_kernel_on_the_card(monkeypatch):
    """On the card ``auto`` takes the mean-field kernel's bf16 mode at an
    eligible shape; on the CPU it runs the bf16 chain, as JAX's default
    branch does; ``compute_dtype="auto"`` stays float32 on the card."""
    args = _scene(1, 64, 16)
    kw = dict(num_classes=12, image_size=64, patch_size=16, top_cls_num=6,
              bilateral_stride=8)
    seen = _dtype_recorders(monkeypatch)
    make_seg_decode_fn(**kw, compute_dtype="bfloat16")(*args)
    make_seg_decode_fn(**kw)(*args)
    assert seen == [("fused", "bfloat16"), ("fused", "float32")]
    monkeypatch.undo()
    pred, _ = make_seg_decode_fn(**kw, compute_dtype="bfloat16")(
        *(torch.Tensor(a) for a in args))
    assert pred.shape == (1, 64, 64)


@pytest.mark.parametrize("name", ["bad_backend", "bad_morph", "bad_dtype"])
def test_unknown_knobs_raise(name):
    knobs = {"bad_backend": dict(crf_backend="dense"),
             "bad_morph": dict(morphology_impl="scan"),
             "bad_dtype": dict(compute_dtype="float16")}[name]
    with pytest.raises(ValueError, match="one of"):
        make_seg_decode_fn(**KW, **knobs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_closing_matmul_matches_jax_and_window(seed):
    """Exact on 0/1 masks: equal to JAX's and to the window closing, at
    odd and even kernel sizes, on maps off the square."""
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 3, 29, 37)) < 0.4).astype(np.float32)
    for k in (7, 4, 1):
        want = np.asarray(jax_closing_mm(jnp.asarray(x), k))
        got = binary_closing_matmul(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      closing(torch.from_numpy(x), k).numpy())
    assert binary_closing_matmul(torch.from_numpy(x).bfloat16()).dtype == \
        torch.bfloat16


# -- routing on the card -------------------------------------------------------

ROUTES = {
    # backend, morph -> (kernel calls, CRF lane of the plain entry, closing)
    ("auto", "auto"): (["fused+closing"], None, None),
    ("auto", "window"): ([], "auto", "window"),
    ("xla", "auto"): ([], "dense", "matmul"),
    ("pallas", "window"): ([], "stream", "window"),
    ("fused", "auto"): ([], "fused", "matmul"),
    ("fused", "matmul"): ([], "fused", "matmul"),
    ("fused_tail", "window"): (["tail"], None, None),
}


@pytest.mark.parametrize("backend,morph", list(ROUTES))
def test_routing_on_the_card(monkeypatch, backend, morph):
    """Which wrapper each knob reaches on a CUDA tensor at an eligible
    shape: ``auto`` the one-kernel CRF + closing; ``fused`` and ``auto``
    with a pinned closing the CRF entry's kernel lanes (``fused`` without
    its closing) and the closing the knob names (``matmul`` for ``auto``
    on the card); ``xla`` the plain chain; ``pallas`` the bilateral
    kernel's lane; ``fused_tail`` the tail kernel."""
    calls, crf_lanes, closings = [], [], []

    def tail(du_coarse, rgb, scores_eff, cand_idx, du_factor, **kw):
        calls.append("tail")
        b, _, gh, gw = du_coarse.shape
        return (torch.zeros(b, gh * du_factor, gw * du_factor, dtype=torch.int32),
                torch.zeros(b, gh * du_factor, gw * du_factor))

    def fused(du, rgb, **kw):
        calls.append("fused+closing" if kw.get("closing_ksize") else "fused")
        return torch.zeros(du.shape)

    def crf(du, rgb, **kw):
        crf_lanes.append(kw["bilateral_impl"])
        return torch.zeros(du.shape, dtype=torch.int32)

    def record(name, real):
        def fn(x, k):
            closings.append(name)
            return real(torch.Tensor(x), k)
        return fn

    monkeypatch.setattr(seg_decode, "seg_decode_tail_fused", tail)
    monkeypatch.setattr(seg_decode, "mean_field_fused", fused)
    monkeypatch.setattr(seg_decode, "dense_crf_batched_du", crf)
    monkeypatch.setattr(seg_decode, "closing", record("window", closing))
    monkeypatch.setattr(seg_decode, "binary_closing_matmul",
                        record("matmul", binary_closing_matmul))
    decode = make_seg_decode_fn(num_classes=12, image_size=64, patch_size=16,
                                top_cls_num=6, bilateral_stride=8,
                                crf_backend=backend, morphology_impl=morph)
    pred, _ = decode(*_scene(2, 64, 16))
    assert pred.shape == (2, 64, 64)
    want_calls, want_lane, want_closing = ROUTES[backend, morph]
    assert calls == want_calls
    assert crf_lanes == ([want_lane] if want_lane else [])
    assert closings == ([want_closing] if want_closing else [])
