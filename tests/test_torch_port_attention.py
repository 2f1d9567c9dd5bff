"""PyTorch port (simseg_tpu_torch): the attention kernel's plain version,
its gate, its routing and its gradients, held against the JAX package.

The JAX kernel runs as its own tests run it, in interpret mode on the CPU.
Bars: bf16 outputs within one bf16 ulp of the JAX kernel's and of its
einsum reference, or 1e-2 where that is larger (both round p and the
output to bf16 after f32 sums taken in another order); the gate and the
gradients (the same plain function on both sides) exactly equal.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.ops.flash_attention import _reference_mha as jax_reference_mha
from simseg_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from simseg_tpu.ops.flash_attention import flash_supported as jax_flash_supported
from simseg_tpu_torch.ops import attention, flash_attention
from simseg_tpu_torch.ops.flash_attention import flash_mha, flash_mha_plain, flash_supported

torch.set_num_threads(1)


def _qkv(seed, b, t, h, hd):
    """bf16-exact standard-normal q, k, v as float32 numpy, q pre-scaled."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    return [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in (q, k, v)]


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("t,hd", [(64, 64), (64, 128), (200, 64), (200, 128)])
def test_plain_matches_jax_kernel_and_reference(t, hd):
    q, k, v = _qkv(t + hd, 1, t, 2, hd)
    ours = flash_mha_plain(*(torch.from_numpy(x).to(torch.bfloat16)
                             for x in (q, k, v)))
    assert ours.dtype == torch.bfloat16 and ours.shape == (1, t, 2, hd)
    ours = ours.float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    for ref in (jax_flash_mha(jq, jk, jv, True), jax_reference_mha(jq, jk, jv)):
        ref = np.asarray(ref.astype(jnp.float32))
        bar = np.maximum(_bf16_ulp(ref), 1e-2)
        assert np.all(np.abs(ours - ref) <= bar), np.abs(ours - ref).max()


GRID = list(itertools.product(
    (1023, 1024, 1297, 1536, 1537), (1023, 1024, 1297, 1536, 1537),
    (32, 64, 192, 256, 320)))


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_supported_equals_jax(dtype, biased):
    bias_t = torch.zeros(1) if biased else None
    bias_j = jnp.zeros(1) if biased else None
    for tq, tk, hd in GRID:
        assert flash_supported(tq, tk, hd, getattr(torch, dtype), bias_t) == \
            jax_flash_supported(tq, tk, hd, getattr(jnp, dtype), bias_j), \
            (tq, tk, hd, dtype, biased)


def test_cpu_attention_never_calls_the_kernel(monkeypatch):
    """A shape in the kernel's band takes the plain path on the CPU."""
    def kernel(*a):
        raise AssertionError("flash_mha called for a CPU tensor")

    monkeypatch.setattr(flash_attention, "flash_mha", kernel)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1024, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    assert flash_supported(1024, 1024, 64, torch.bfloat16, None)
    out = attention.multi_head_attention(q, k, v, 1)
    assert out.shape == (1, 1024, 64) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_equal_plain_autograd(dtype):
    """The autograd.Function's backward recomputes through the plain
    version: its gradients are the plain version's own."""
    q, k, v = _qkv(5, 2, 40, 2, 64)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 40, 2, 64)).astype(np.float32)).to(dtype)

    def grads(fn):
        leaves = [torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v)]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g)

    out, got = grads(flash_mha)
    want_out, want = grads(flash_mha_plain)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
