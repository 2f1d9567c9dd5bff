"""PyTorch port (simseg_tpu_torch): the training form of the attention
kernel (``flash_mha_train``: forward with log-sum-exp, the backward kernel),
its gate and the lane routing, held against the JAX package.

The JAX kernel runs as its own tests run it (``tests/test_flash_attention.py``),
in interpret mode on the CPU; the port runs its plain forward and plain
backward there. Bars: float32 gradients to 1e-5 (the same f32 arithmetic in
another order); bf16 gradients, per tensor, max abs error <= 2e-2 x the JAX
result's largest entry and mean abs error <= 1e-2 x its mean abs entry (the
bars ``chip_smoke.py`` holds the CUDA kernel to: p and ds are rounded to
bf16 after f32 sums taken in another order); gates and lanes equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.ops.flash_attention as jax_fa
from simseg_tpu.ops.attention import multi_head_attention as jax_mha
from simseg_tpu_torch.ops import attention, flash_attention
from simseg_tpu_torch.ops.flash_attention import (flash_mha_train,
                                                  flash_mha_train_bwd,
                                                  flash_mha_train_bwd_plain,
                                                  flash_train_supported)

torch.set_num_threads(2)


def _inputs(seed, b, t, h, hd):
    """bf16-exact q (pre-scaled), k, v and g as float32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
                  for _ in range(4))
    q *= hd ** -0.5
    return [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in (q, k, v, g)]


def _port(dtype, q, k, v, g):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = flash_mha_train(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


def _jax(dtype, q, k, v, g):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_mha_train(a, b, c, True),
                       *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


@pytest.mark.parametrize("shape", [(2, 24, 3, 64), (1, 70, 2, 128)])
def test_train_f32_matches_jax_interpret(shape):
    q, k, v, g = _inputs(sum(shape), *shape)
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          _port(torch.float32, q, k, v, g),
                          _jax(jnp.float32, q, k, v, g)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 24, 3, 64), (1, 70, 2, 128)])
def test_train_bf16_within_the_kernel_bars(shape):
    q, k, v, g = _inputs(sum(shape) + 1, *shape)
    ours = _port(torch.bfloat16, q, k, v, g)
    ref = _jax(jnp.bfloat16, q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        err = np.abs(a - b)
        assert err.max() <= 2e-2 * np.abs(b).max(), (name, err.max())
        assert err.mean() <= 1e-2 * np.abs(b).mean(), (name, err.mean())


def test_bwd_plain_is_the_cpu_backward():
    """On the CPU the autograd.Function's backward is the plain backward."""
    q, k, v, g = _inputs(3, 1, 16, 2, 64)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)]
    _, dq, dk, dv = _port(torch.bfloat16, q, k, v, g)
    for a, b in zip((dq, dk, dv), flash_mha_train_bwd_plain(*t)):
        assert np.array_equal(a, b.float().numpy())


GRID = list(itertools.product((1, 8), (12,), (1023, 1024, 1297, 1536, 1537),
                              (1024, 1297, 1537), (32, 64, 192, 256, 320)))


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_flash_train_supported_equals_jax(dtype, biased):
    bias_t = torch.zeros(1) if biased else None
    bias_j = jnp.zeros(1) if biased else None
    for b, h, tq, tk, hd in GRID:
        assert flash_train_supported(b, h, tq, tk, hd, getattr(torch, dtype),
                                     bias_t) == jax_fa.flash_train_supported(
            b, h, tq, tk, hd, getattr(jnp, dtype), bias_j), (b, h, tq, tk, hd)


_JAX_KERNELS = {"flash_mha_train": "train", "flash_mha": "flash",
                "flash_mha_rowblock": "rowblock", "flash_mha_stream": "stream"}


def _jax_lane(monkeypatch, t, training, biased):
    """The kernel the JAX package's multi_head_attention picks on its
    accelerator, recorded while its branches are traced."""
    picked = []
    for name in _JAX_KERNELS:
        monkeypatch.setattr(
            jax_fa, name,
            lambda qh, kh, vh, interpret=False, _n=name:
            picked.append(_n) or jnp.zeros_like(qh))
    q = jax.ShapeDtypeStruct((1, t, 64), jnp.bfloat16)
    bias = jnp.zeros((1, 1, 1, t), jnp.float32) if biased else None
    jax.eval_shape(lambda a, b, c: jax_mha(a, b, c, 1, bias, jnp.bfloat16,
                                           training=training), q, q, q)
    return _JAX_KERNELS[picked[0]] if picked else "plain"


@pytest.mark.parametrize("training", [False, True])
def test_lane_matches_jax(monkeypatch, training):
    for t, biased in itertools.product((325, 1024, 1297, 1536, 1601, 1700,
                                        4100), (False, True)):
        want = _jax_lane(monkeypatch, t, training, biased)
        got = attention.attention_lane(1, 1, t, t, 64, torch.bfloat16,
                                       torch.zeros(1) if biased else None,
                                       training)
        assert got == want, (t, biased, training)


def _spy_lanes(monkeypatch):
    seen = []
    real = attention.attention_lane

    def spy(*args):
        lane = real(*args)
        seen.append((args[2], args[-1], lane))
        return lane

    monkeypatch.setattr(attention, "attention_lane", spy)
    return seen


def test_differentiated_calls_take_the_train_lane(monkeypatch):
    """Grad mode and an input that requires grad make a call 'training';
    the same call under no_grad, or on inputs that need no grad, is not."""
    seen = _spy_lanes(monkeypatch)
    x = torch.zeros(1, 1024, 64, dtype=torch.bfloat16)
    w = x.clone().requires_grad_()
    attention.multi_head_attention(w, w, w, 1)
    attention.multi_head_attention(x, x, x, 1)
    with torch.no_grad():
        attention.multi_head_attention(w, w, w, 1)
    assert [s[1:] for s in seen] == [(True, "train"), (False, "flash"),
                                     (False, "flash")]


def test_seg_eval_runs_without_grad(monkeypatch):
    """The segmentation eval keeps its inference lane: every attention call
    it makes is under no_grad, though the model's parameters require grad."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.models.clip import CLIPModel
    from simseg_tpu_torch.tasks.seg_eval import (evaluate_benchmark,
                                                 make_seg_features,
                                                 make_seg_predict,
                                                 zero_shot_classifier)

    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16, image_k=3)
    assert all(p.requires_grad for p in model.parameters())
    seen = _spy_lanes(monkeypatch)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 32, 32, 3)).astype(np.uint8))
    tok = WordPieceTokenizer(make_test_vocab(["cat", "dog"]))
    bank = zero_shot_classifier(model, ["cat", "dog"], tok, max_length=8,
                                device="cpu")
    make_seg_features(model, input_size=32, scales=(1.0, 2.0),
                      device="cpu")(images)
    make_seg_predict(model, 2, 2, input_size=32, bilateral_stride=4,
                     device="cpu")(images, bank)
    labels = np.zeros((2, 32, 32), np.uint8)
    evaluate_benchmark([{"image": images.numpy(), "mask_label": labels,
                         "mask_h": [32, 32], "mask_w": [32, 32]}], model, tok,
                       ["cat", "dog"], 2, "pascal_voc", input_size=32,
                       bilateral_stride=4, max_length=8, device="cpu")
    assert seen and not any(training for _, training, _ in seen)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device (the kernel branch of a
    wrapper on a machine without a card)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _missing_library():
    raise OSError("lib.so: cannot open shared object file")


def _no_plain(*a, **k):
    raise AssertionError("fell back to the plain version")


def test_train_forward_refuses_cuda_tensor_without_library(monkeypatch):
    monkeypatch.setattr(flash_attention, "_library", _missing_library)
    monkeypatch.setattr(flash_attention, "flash_mha_plain", _no_plain)
    q, k, v = (torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
               .as_subclass(_CudaLooking) for _ in range(3))
    launches = flash_attention.LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        flash_mha_train(q, k, v)
    assert flash_attention.LAUNCHES == launches


def test_train_backward_refuses_cuda_tensor_without_library(monkeypatch):
    monkeypatch.setattr(flash_attention, "_bwd_library", _missing_library)
    monkeypatch.setattr(flash_attention, "flash_mha_train_bwd_plain", _no_plain)
    q, k, v, o, g = (torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
                     .as_subclass(_CudaLooking) for _ in range(5))
    lse = torch.zeros(1, 2, 8).as_subclass(_CudaLooking)
    launches = flash_attention.BWD_LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        flash_mha_train_bwd(q, k, v, o, g, lse)
    assert flash_attention.BWD_LAUNCHES == launches


def test_kernel_operand_keeps_fused_qkv_views_in_place():
    """q, k, v as views into a fused (B, T, 3, H, hd) tensor, as the ViT
    makes them, reach the kernels as they are: no copy per call."""
    qkv = torch.zeros(2, 300, 3, 2, 64, dtype=torch.bfloat16)
    for x in qkv.unbind(2):
        assert flash_attention._kernel_operand(x) is x
    flat = torch.zeros(2, 300, 3 * 128, dtype=torch.bfloat16)
    for x in (c.unflatten(-1, (2, 64)) for c in flat.chunk(3, dim=-1)):
        assert flash_attention._kernel_operand(x) is x


@pytest.mark.parametrize("make", [
    # token stride 132 elements: rows not 16-byte aligned
    lambda: torch.zeros(2, 300, 132, dtype=torch.bfloat16)[..., :128].unflatten(-1, (2, 64)),
    # head dim not unit-stride
    lambda: torch.zeros(2, 300, 64, 2, dtype=torch.bfloat16).transpose(-1, -2),
    # a batch and token dimension broadcast with stride 0 (an expanded g)
    lambda: torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16).expand(3, 300, 2, 64),
    # base pointer 2 bytes past a 16-byte boundary
    lambda: torch.zeros(2 * 300 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 300, 2, 64),
])
def test_kernel_operand_copies_what_the_kernels_cannot_read(make):
    x = make()
    got = flash_attention._kernel_operand(x)
    assert got is not x and got.is_contiguous() and torch.equal(got, x)


def test_backward_kernel_wrapper_takes_no_cpu_tensor():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="runs on CUDA"):
        flash_mha_train_bwd(x, x, x, x, x, torch.zeros(1, 2, 8))
