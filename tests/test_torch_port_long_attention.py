"""PyTorch port (simseg_tpu_torch): the long-sequence attention lanes
(``flash_mha_rowblock``, ``flash_mha_stream``), their gates and the lane
routing, held against the JAX package.

The JAX kernels run as their own tests run them
(``tests/test_flash_attention.py``), in interpret mode on the CPU, the
streaming pair at tile 128 so that a short sequence spans several tiles;
the port runs each lane's plain forward and ``flash_mha_long_bwd_plain``
there. Bars: float32 outputs and gradients to 1e-5 (the same f32 arithmetic
in another order; the plain streaming forward's global row max stands in
for the kernel's running max, which in float32 changes only rounding);
bf16, per tensor, max abs error <= 2e-2 x the JAX result's largest entry
and mean abs error <= 1e-2 x its mean abs entry (the kernel bars of
``chip_smoke.py``: p and ds are rounded to bf16 after f32 sums taken in
another order); gates and lanes equal at every band edge.
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
from simseg_tpu_torch.ops.flash_attention import (flash_mha_long_bwd_plain,
                                                  flash_mha_rowblock,
                                                  flash_mha_stream,
                                                  flash_rowblock_supported,
                                                  flash_stream_supported)

torch.set_num_threads(2)

SHAPES = [(2, 300, 2, 64), (1, 520, 2, 128)]
LANES = {"rowblock": (flash_mha_rowblock,
                      lambda a, b, c: jax_fa.flash_mha_rowblock(a, b, c, True)),
         "stream": (flash_mha_stream,
                    lambda a, b, c: jax_fa.flash_mha_stream(a, b, c, True, 128))}


def _inputs(seed, b, t, h, hd):
    """bf16-exact q (pre-scaled), k, v and g as float32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
                  for _ in range(4))
    q *= hd ** -0.5
    return [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in (q, k, v, g)]


def _port(lane, dtype, q, k, v, g):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = LANES[lane][0](*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


def _jax(lane, dtype, q, k, v, g):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(LANES[lane][1], *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


@pytest.mark.parametrize("lane,shape", list(itertools.product(LANES, SHAPES)))
def test_long_f32_matches_jax_interpret(lane, shape):
    q, k, v, g = _inputs(sum(shape), *shape)
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          _port(lane, torch.float32, q, k, v, g),
                          _jax(lane, jnp.float32, q, k, v, g)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("lane,shape", list(itertools.product(LANES, SHAPES)))
def test_long_bf16_within_the_kernel_bars(lane, shape):
    q, k, v, g = _inputs(sum(shape) + 1, *shape)
    ours = _port(lane, torch.bfloat16, q, k, v, g)
    ref = _jax(lane, jnp.bfloat16, q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        err = np.abs(a - b)
        assert err.max() <= 2e-2 * np.abs(b).max(), (name, err.max())
        assert err.mean() <= 1e-2 * np.abs(b).mean(), (name, err.mean())


@pytest.mark.parametrize("lane", list(LANES))
def test_long_bwd_plain_is_the_cpu_backward(lane):
    """On the CPU a lane's backward is ``flash_mha_long_bwd_plain`` on the
    forward's own output and log-sum-exp."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(5, 1, 40, 2, 64))
    plain = flash_attention._LONG_PLAIN[lane]
    out, lse = plain(q, k, v, with_lse=True)
    assert torch.equal(out, plain(q, k, v))
    want_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                            k.float()), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)
    _, dq, dk, dv = _port(lane, torch.bfloat16, *(x.float().numpy()
                                                  for x in (q, k, v, g)))
    for a, b in zip((dq, dk, dv), flash_mha_long_bwd_plain(q, k, v, out, g, lse)):
        assert np.array_equal(a, b.float().numpy())


# ------------------------------------------------------------ gates, lanes

EDGES = (1023, 1024, 1536, 1537, 1601, 1680, 1681, 2026, 4096, 4097, 5185)
GRID = list(itertools.product(EDGES, (EDGES[4], EDGES[8], 4097), (32, 64, 192,
                                                                  256, 320)))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_long_gates_equal_jax(dtype, biased, training):
    bias_t = torch.zeros(1) if biased else None
    bias_j = jnp.zeros(1) if biased else None
    for tq, tk, hd in GRID:
        for t_tk in (tq, tk):   # self-attention and cross shapes
            args_t = (tq, t_tk, hd, getattr(torch, dtype), bias_t)
            args_j = (tq, t_tk, hd, getattr(jnp, dtype), bias_j)
            assert flash_rowblock_supported(*args_t, training) == \
                jax_fa.flash_rowblock_supported(*args_j, training), args_t
            assert flash_stream_supported(*args_t) == \
                jax_fa.flash_stream_supported(*args_j), args_t


_JAX_KERNELS = {"flash_mha_train": "train", "flash_mha": "flash",
                "flash_mha_rowblock": "rowblock", "flash_mha_stream": "stream"}


def _jax_lane(monkeypatch, t, training, biased, dtype):
    """The kernel the JAX package's multi_head_attention picks on its
    accelerator, recorded while its branches are traced."""
    picked = []
    for name in _JAX_KERNELS:
        monkeypatch.setattr(
            jax_fa, name,
            lambda qh, kh, vh, interpret=False, _n=name:
            picked.append(_n) or jnp.zeros_like(qh))
    q = jax.ShapeDtypeStruct((1, t, 64), dtype)
    bias = jnp.zeros((1, 1, 1, t), jnp.float32) if biased else None
    jax.eval_shape(lambda a, b, c: jax_mha(a, b, c, 1, bias, dtype,
                                           training=training), q, q, q)
    return _JAX_KERNELS[picked[0]] if picked else "plain"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("training", [False, True])
def test_lane_matches_jax_at_band_edges(monkeypatch, training, dtype):
    for t, biased in itertools.product(EDGES, (False, True)):
        want = _jax_lane(monkeypatch, t, training, biased, getattr(jnp, dtype))
        got = attention.attention_lane(1, 1, t, t, 64, getattr(torch, dtype),
                                       torch.zeros(1) if biased else None,
                                       training)
        assert got == want, (t, biased, training, dtype)


# ------------------------------------------- the card's branch, without one

class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device (the kernel branch of a
    wrapper on a machine without a card)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _no_plain(*a, **k):
    raise AssertionError("fell back to a plain version")


@pytest.fixture
def spied_kernels(monkeypatch):
    """Replaces the two kernel launches by recorders; every plain version
    raises."""
    calls = []

    def launch(qh, kh, vh, with_lse=False, lane="flash"):
        calls.append(("fwd", lane, qh.shape[1], with_lse))
        out = torch.zeros(qh.shape, dtype=qh.dtype)
        b, t, h, _ = qh.shape
        return (out, torch.zeros(b, h, t)) if with_lse else out

    def bwd(qh, kh, vh, out, g, lse):
        calls.append(("bwd", qh.shape[1], tuple(lse.shape)))
        return tuple(torch.zeros(x.shape, dtype=x.dtype) for x in (qh, kh, vh))

    monkeypatch.setattr(flash_attention, "_launch", launch)
    monkeypatch.setattr(flash_attention, "flash_mha_train_bwd", bwd)
    for name in ("flash_mha_plain", "flash_mha_rowblock_plain",
                 "flash_mha_stream_plain", "flash_mha_long_bwd_plain",
                 "flash_mha_train_bwd_plain"):
        monkeypatch.setattr(flash_attention, name, _no_plain)
    monkeypatch.setitem(flash_attention._LONG_PLAIN, "rowblock", _no_plain)
    monkeypatch.setitem(flash_attention._LONG_PLAIN, "stream", _no_plain)
    return calls


@pytest.mark.parametrize("t,lane", [(1681, "rowblock"), (2026, "rowblock"),
                                    (4096, "rowblock"), (4097, "stream"),
                                    (1297, "flash")])
def test_inference_dispatches_each_band_to_its_kernel(spied_kernels, t, lane):
    """On a CUDA tensor every kernel band launches its wrapper's kernel,
    without the log-sum-exp, and never reaches a plain path."""
    x = torch.zeros(1, t, 128, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    with torch.no_grad():
        out = attention.multi_head_attention(x, x, x, 2)
    assert out.shape == (1, t, 128)
    assert spied_kernels == [("fwd", lane, t, False)]


@pytest.mark.parametrize("t,lane", [(1537, "rowblock"), (1601, "rowblock"),
                                    (5185, "stream"), (1297, "train")])
def test_training_dispatches_each_band_to_both_kernels(spied_kernels, t, lane):
    """A differentiated call writes the log-sum-exp and its backward is the
    backward kernel, in every kernel band (1537 and 1601: the row-block
    lane's training floor sits below its inference floor)."""
    w = torch.zeros(1, t, 128, dtype=torch.bfloat16).requires_grad_()
    x = w.as_subclass(_CudaLooking)
    out = attention.multi_head_attention(x, x, x, 2)
    out.float().sum().backward()
    assert spied_kernels == [("fwd", lane, t, True), ("bwd", t, (1, 2, t))]


def _missing_library():
    raise OSError("lib.so: cannot open shared object file")


@pytest.mark.parametrize("lane", list(LANES))
def test_long_lanes_refuse_cuda_tensor_without_library(monkeypatch, lane):
    monkeypatch.setattr(flash_attention, "_library", _missing_library)
    for name in ("flash_mha_plain", "flash_mha_rowblock_plain",
                 "flash_mha_stream_plain"):
        monkeypatch.setattr(flash_attention, name, _no_plain)
    monkeypatch.setitem(flash_attention._LONG_PLAIN, lane, _no_plain)
    q, k, v = (torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
               .as_subclass(_CudaLooking) for _ in range(3))
    before = dict(flash_attention.LANE_CALLS), flash_attention.LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        LANES[lane][0](q, k, v)
    assert (flash_attention.LANE_CALLS, flash_attention.LAUNCHES) == before
