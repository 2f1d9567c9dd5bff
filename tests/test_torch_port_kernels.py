"""PyTorch port (simseg_tpu_torch): the hand-written CUDA kernels against
their plain PyTorch versions, on the card. Imports neither JAX nor
``simseg_tpu``, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

(``--noconftest``: tests/conftest.py configures JAX). Skipped where there is
no CUDA device. Bars, CRF: >= 99.9% mask agreement (a pixel at the
threshold may flip under another f32 summation order); the closing
composition and the zero-iteration threshold are exact. The decode tail:
>= 99.9% of pred against its plain version, >= 99.99% against the
mean-field kernel with the unfused tail (the same CRF code). Attention and
the bilateral product and the attention backward: as stated at each test.
The int8 product (``torch._int_mm``, a library GEMM: JAX's is an XLA dot)
is exact; a quantised or token-merging tower on the card is held against
the same code on the CPU in float32 (a layer's int8 input codes equal on
>= 99.99% of entries on the same input, gather maps on >= 99.9%,
per-token cosine >= 0.9999, 0.999 for a quantised tower: float32 summation
order can move an activation across a rounding boundary). The nvJPEG
decode: >= 99% of channel values within 2 levels of PIL's (the IDCTs
round differently); the resize on the card equal to the CPU's.
"""

import copy
import unittest.mock

import numpy as np
import pytest
import torch

from simseg_tpu_torch.models.vit import build_vit
from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention, quant
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample
from simseg_tpu_torch.ops.seg_decode import decode_tail


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the port's kernels)")
    return torch.device("cuda")


def _case(seed, b, k, h, device):
    rng = np.random.default_rng(seed)
    p = np.clip(rng.uniform(0.02, 0.98, (b, k, h, h)), 0.0, 1.0)
    du = (np.log(p + 1e-8) - np.log(1.0 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, h, h, 3)).astype(np.uint8)
    return torch.from_numpy(du).to(device), torch.from_numpy(rgb).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,k,h,stride", [
    (0, 1, 1, 16, 1), (3, 2, 3, 32, 4), (13, 1, 2, 96, 4), (5, 1, 8, 40, 8),
    (21, 2, 5, 288, 8)])
def test_kernel_matches_plain(cuda_device, seed, b, k, h, stride):
    du, rgb = _case(seed, b, k, h, cuda_device)
    for ck in (0, 7):
        before = crf_fused.LAUNCHES
        got = crf_fused.mean_field_fused(du, rgb, stride=stride, closing_ksize=ck)
        assert crf_fused.LAUNCHES == before + 1
        want = crf_fused.mean_field_fused_plain(du, rgb, stride=stride,
                                                closing_ksize=ck)
        assert (got == want).float().mean().item() >= 0.999
    raw = crf_fused.mean_field_fused(du, rgb, stride=stride)
    closed = crf_fused.mean_field_fused(du, rgb, stride=stride, closing_ksize=7)
    assert torch.equal(closing(raw, 7), closed)
    zero = crf_fused.mean_field_fused(du, rgb, stride=stride, num_iters=0)
    assert torch.equal(zero, (du > 0).float())


def _rect_case(seed, b, k, h, w, device):
    rng = np.random.default_rng(seed)
    p = np.clip(rng.uniform(0.02, 0.98, (b, k, h, w)), 0.0, 1.0)
    du = (np.log(p + 1e-8) - np.log(1.0 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, h, w, 3)).astype(np.uint8)
    return torch.from_numpy(du).to(device), torch.from_numpy(rgb).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,k,h,w,stride,sxy,iters", [
    (30, 2, 3, 96, 160, 8, 3.0, 3),     # H != W
    (31, 2, 2, 200, 200, 8, 3.0, 3),    # H not a multiple of the tile
    (32, 1, 2, 320, 320, 8, 3.0, 3),    # N = 1600, fused_eligible's edge
    (33, 1, 3, 512, 512, 16, 3.0, 3),   # 512^2 at stride 16
    (34, 1, 2, 512, 512, 64, 3.0, 3),   # stride past a whole-cell tile
    (35, 2, 2, 96, 96, 8, 5.3, 3),      # radius ceil(3 x 5.3) = 16
    (36, 1, 8, 64, 64, 4, 3.0, 3),      # K = 8, B = 1
    (37, 2, 3, 64, 96, 8, 3.0, 0),      # no iteration
    (38, 2, 3, 64, 96, 8, 3.0, 1)])     # one iteration
def test_kernel_edges_match_plain(cuda_device, seed, b, k, h, w, stride, sxy, iters):
    """The shapes a banded or tiled design has edges at, each against the
    plain version (>= 99.9% of masks), with and without the closing, whose
    composition is exact."""
    du, rgb = _rect_case(seed, b, k, h, w, cuda_device)
    kw = dict(stride=stride, gaussian_sxy=sxy, num_iters=iters)
    for ck in (0, 7):
        before = crf_fused.LAUNCHES
        got = crf_fused.mean_field_fused(du, rgb, closing_ksize=ck, **kw)
        assert crf_fused.LAUNCHES == before + 1
        want = crf_fused.mean_field_fused_plain(du, rgb, closing_ksize=ck, **kw)
        assert (got == want).float().mean().item() >= 0.999
    raw = crf_fused.mean_field_fused(du, rgb, **kw)
    closed = crf_fused.mean_field_fused(du, rgb, closing_ksize=7, **kw)
    assert torch.equal(closing(raw, 7), closed)
    if iters == 0:
        assert torch.equal(raw, (du > 0).float())


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    """Two calls of each entry point give the same bits."""
    du, rgb = _case(40, 2, 5, 288, cuda_device)
    one = crf_fused.mean_field_fused(du, rgb, stride=8, closing_ksize=7)
    assert torch.equal(one, crf_fused.mean_field_fused(du, rgb, stride=8,
                                                       closing_ksize=7))
    du_c, rgb, scores, idx = _tail_case(41, 2, 5, 18, 16, cuda_device)
    pred, best_w = crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, 16,
                                                   stride=8)
    pred2, best_w2 = crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, 16,
                                                     stride=8)
    assert torch.equal(pred, pred2) and torch.equal(best_w, best_w2)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    du, rgb = _case(0, 1, 9, 16, cuda_device)
    with pytest.raises(ValueError, match="<= 8"):
        crf_fused.mean_field_fused(du, rgb, stride=4)
    scores = torch.ones(1, 9, device=cuda_device)
    with pytest.raises(ValueError, match="<= 8"):
        crf_fused.seg_decode_tail_fused(du[..., :4, :4], rgb[:, :16, :16], scores,
                                        scores.int(), 4, stride=4)
    with pytest.raises(ValueError, match="contiguous"):
        crf_fused.mean_field_fused(du[:, :2].transpose(2, 3), rgb, stride=4)
    with pytest.raises(ValueError, match="rgb on"):
        crf_fused.mean_field_fused(du[:, :2], rgb.cpu(), stride=4)


def _tail_case(seed, b, k, grid, factor, device, grid_w=None):
    """Decode-form patch-grid unaries (min-max normalised smooth maps) on a
    grid x grid_w grid (square by default), images, scores with an invalid
    candidate, a negative one and a tie."""
    rng = np.random.default_rng(seed)
    gw = grid_w or grid
    c = rng.normal(size=(b, k, grid + 2, gw + 2))
    c = (c[..., :-2, :-2] + c[..., 1:-1, 1:-1] + c[..., 2:, 2:])[..., :grid, :gw]
    lo, hi = c.min(axis=(-2, -1), keepdims=True), c.max(axis=(-2, -1), keepdims=True)
    p = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
    du_c = (np.log(p + 1e-8) - np.log(1 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, grid * factor, gw * factor, 3)).astype(np.uint8)
    scores = rng.uniform(0.1, 0.5, (b, k)).astype(np.float32)
    scores[:, 0] = 0.0
    if k > 2:
        scores[:, 1] = -0.2
        scores[:, -1] = scores[:, -2]
    idx = rng.permutation(np.arange(1, 21))[:k][None].repeat(b, 0).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (du_c, rgb, scores, idx)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,k,grid,factor,stride,ck,gw,iters", [
    (0, 1, 1, 8, 4, 4, 0, None, 3), (1, 2, 4, 8, 4, 4, 7, None, 3),
    (2, 2, 5, 18, 16, 8, 7, None, 3), (3, 1, 8, 10, 4, 8, 7, None, 3),
    (4, 2, 5, 6, 16, 8, 7, 10, 3),    # H != W: 96 x 160
    (5, 1, 3, 32, 16, 16, 7, None, 3),  # 512^2 at stride 16
    (6, 2, 5, 18, 16, 8, 7, None, 0), (7, 2, 5, 18, 16, 8, 7, None, 1)])
def test_tail_kernel_matches_plain_and_the_kernel_lane(cuda_device, seed, b, k,
                                                       grid, factor, stride, ck,
                                                       gw, iters):
    du_c, rgb, scores, idx = _tail_case(seed, b, k, grid, factor, cuda_device, gw)
    kw = dict(stride=stride, closing_ksize=ck, num_iters=iters)
    before = crf_fused.TAIL_LAUNCHES
    pred, best_w = crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, factor, **kw)
    assert crf_fused.TAIL_LAUNCHES == before + 1
    assert pred.dtype == torch.int32 and best_w.dtype == torch.float32
    want_p, want_w = crf_fused.seg_decode_tail_fused_plain(du_c, rgb, scores, idx,
                                                           factor, **kw)
    assert (pred == want_p).float().mean().item() >= 0.999
    assert (best_w == want_w).float().mean().item() >= 0.999
    masks = crf_fused.mean_field_fused(nearest_upsample(du_c, factor).contiguous(),
                                       rgb, **kw)
    lane_p, lane_w = decode_tail(masks, idx, scores, torch.ones_like(scores, dtype=torch.bool))
    assert (pred == lane_p).float().mean().item() >= 0.9999
    assert (best_w == lane_w).float().mean().item() >= 0.9999


# --------------------------------------------------------------- attention

def _qkv(seed, b, t, h, hd, device):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, hd, generator=gen) for _ in range(3))
    q = q * hd ** -0.5
    return [x.to(device=device, dtype=torch.bfloat16) for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,hd", [
    (1, 64, 64, 1, 64), (2, 200, 200, 2, 128), (1, 1297, 1297, 3, 64),
    (1, 100, 333, 2, 192), (1, 65, 130, 1, 256),
    # the edges of the 128-key tile and of the 128-row CTA at hd 64
    (1, 1, 1, 2, 64), (1, 17, 17, 2, 64), (1, 127, 127, 2, 64),
    (1, 128, 128, 2, 64), (2, 129, 129, 2, 64), (1, 191, 191, 2, 64),
    (1, 193, 193, 2, 64),
    # Tq != Tk across a tile edge
    (1, 300, 129, 2, 64), (1, 129, 257, 2, 64),
    # wide heads: 64-key tiles at hd 192 and 256
    (1, 129, 129, 2, 128), (1, 129, 65, 2, 192), (1, 257, 257, 2, 256)])
def test_flash_kernel_matches_plain(cuda_device, b, tq, tk, h, hd):
    """Max abs error <= 2e-2 and mean <= 2e-3 (the kernel divides by the
    softmax sum after its bf16 cast of p, the plain version before); the
    training form's log-sum-exp within 1e-5 x its largest entry (+ 1e-5) of
    torch.logsumexp over the f32 scores, with the same output; a second call
    bit-equal to the first (no atomics)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, _, _ = _qkv(tq, b, tq, h, hd, cuda_device)
    _, k, v = _qkv(tk + 1, b, tk, h, hd, cuda_device)
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_mha(q, k, v)
    assert flash_attention.LAUNCHES == before + 1
    want = flash_attention.flash_mha_plain(q, k, v)
    err = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == (b, tq, h, hd)
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    out, lse = flash_attention._launch(q, k, v, with_lse=True)
    want_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                            k.float()), dim=-1)
    assert lse.shape == (b, h, tq) and torch.equal(out, got)
    assert (lse - want_lse).abs().max().item() <= 1e-5 * want_lse.abs().max().item() + 1e-5
    assert torch.equal(flash_attention.flash_mha(q, k, v), got)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k and v as views into a fused qkv tensor, as the ViT makes them,
    read in place (q pre-scaled in place)."""
    qkv = torch.randn(2, 300, 3 * 128, device=cuda_device).to(torch.bfloat16)
    qkv[..., :128] *= 0.125
    q, k, v = (x.reshape(2, 300, 2, 64) for x in qkv.chunk(3, dim=-1))
    assert all(flash_attention._kernel_operand(x) is x for x in (q, k, v))
    got = flash_attention.flash_mha(q, k, v)
    want = flash_attention.flash_mha_plain(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(0, 1, 64, 1, 32, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_mha(q, k, v)
    q, k, v = _qkv(0, 1, 64, 1, 64, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention.flash_mha(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="must be"):
        flash_attention.flash_mha(q, k[:, :, :, :32], v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,hd", [
    (1, 64, 64, 1, 64), (2, 200, 200, 2, 128), (1, 1297, 1297, 3, 64),
    (1, 130, 70, 2, 64), (1, 77, 77, 2, 192), (1, 65, 65, 1, 256),
    # the tiles' edges: T below one 64-row tile, one past a 128-row
    # (dk/dv) and a 192-row (dq) resident tile
    (1, 17, 17, 2, 64), (2, 129, 129, 2, 64), (1, 193, 193, 2, 64)])
def test_flash_bwd_kernel_matches_plain(cuda_device, b, tq, tk, h, hd):
    """The training forward's log-sum-exp, and dq, dk, dv of the backward
    kernel: per gradient max abs error <= 2e-2 x the plain result's largest
    entry and mean <= 1e-2 x its mean abs entry (delta from the bf16 output,
    p and ds rounded to bf16 after f32 sums in another order)."""
    q, _, _ = _qkv(tq, b, tq, h, hd, cuda_device)
    _, k, v = _qkv(tk + 1, b, tk, h, hd, cuda_device)
    g = _qkv(tq + 2, b, tq, h, hd, cuda_device)[1]
    out, lse = flash_attention._launch(q, k, v, with_lse=True)
    want_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                            k.float()), dim=-1)
    assert (lse - want_lse).abs().max().item() <= 1e-5 * want_lse.abs().max().item() + 1e-5
    before = flash_attention.BWD_LAUNCHES
    got = flash_attention.flash_mha_train_bwd(q, k, v, out, g, lse)
    assert flash_attention.BWD_LAUNCHES == before + 1
    for x, y in zip(got, flash_attention.flash_mha_train_bwd_plain(q, k, v, g)):
        err, ref = (x.float() - y.float()).abs(), y.float().abs()
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        assert err.max() <= 2e-2 * ref.max() and err.mean() <= 1e-2 * ref.mean()


def _bwd_case(b, t, h, hd, device):
    """q, k, v as views into a fused (B, T, 3, H, hd) tensor (q pre-scaled
    in place), g, and the forward kernel's output and log-sum-exp."""
    gen = torch.Generator().manual_seed(t)
    qkv = torch.randn(b, t, 3, h, hd, generator=gen)
    qkv[:, :, 0] *= hd ** -0.5
    qkv = qkv.to(device=device, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    g = torch.randn(b, t, h, hd, generator=gen).to(device=device, dtype=torch.bfloat16)
    out, lse = flash_attention._launch(q, k, v, with_lse=True)
    return q, k, v, g, out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hd", [(2, 1297, 3, 64), (1, 300, 2, 128)])
def test_flash_bwd_kernel_reads_fused_qkv_views(cuda_device, b, t, h, hd):
    """q, k, v strided views into one fused tensor, as the ViT makes them,
    read in place: the bars of test_flash_bwd_kernel_matches_plain."""
    q, k, v, g, out, lse = _bwd_case(b, t, h, hd, cuda_device)
    assert flash_attention._kernel_operand(k) is k
    got = flash_attention.flash_mha_train_bwd(q, k, v, out, g, lse)
    for x, y in zip(got, flash_attention.flash_mha_train_bwd_plain(q, k, v, g)):
        err, ref = (x.float() - y.float()).abs(), y.float().abs()
        assert err.max() <= 2e-2 * ref.max() and err.mean() <= 1e-2 * ref.mean()


@pytest.mark.cuda
def test_flash_bwd_kernel_is_deterministic(cuda_device):
    """No atomics: every output element is written once, so two calls give
    bit-equal gradients."""
    q, k, v, g, out, lse = _bwd_case(2, 1297, 4, 64, cuda_device)
    first = flash_attention.flash_mha_train_bwd(q, k, v, out, g, lse)
    second = flash_attention.flash_mha_train_bwd(q, k, v, out, g, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_train_gradients_through_autograd(cuda_device):
    """flash_mha_train under autograd launches both kernels once and its
    gradients equal the backward kernel's own."""
    q, k, v = (x.requires_grad_() for x in _qkv(3, 2, 1100, 2, 64, cuda_device))
    g = torch.randn(2, 1100, 2, 64, device=cuda_device).to(torch.bfloat16)
    fwd, bwd = flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES
    out = flash_attention.flash_mha_train(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    _, lse = flash_attention._launch(q.detach(), k.detach(), v.detach(), with_lse=True)
    want = flash_attention.flash_mha_train_bwd(q.detach(), k.detach(), v.detach(),
                                               out.detach(), g, lse)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("lane,t", [(lane, t) for lane in ("rowblock", "stream")
                                    for t in (1601, 2026, 4097)] + [("stream", 8192)])
def test_long_lanes_match_their_plain_pairs(cuda_device, lane, t):
    """A long lane's forward (no log-sum-exp, as in inference) and its
    autograd forward and backward, against the lane's plain forward and
    ``flash_mha_long_bwd_plain``. Forward, relative to the plain output
    (|o| shrinks as T^-1/2): max abs error <= 2e-2 x its largest entry,
    mean <= 7e-3 x its mean abs entry, and the scale error
    |1 - <out, plain> / <plain, plain>| <= 3e-5 (an unmasked partial tile
    moves it by 6e-3 or more). Per gradient: max <= 2e-2 x the plain
    result's largest entry, mean <= 1e-2 x its mean abs entry (the bars of
    the whole-T backward)."""
    wrapper = getattr(flash_attention, f"flash_mha_{lane}")
    plain = getattr(flash_attention, f"flash_mha_{lane}_plain")
    q, k, v = _qkv(t, 1, t, 2, 64, cuda_device)
    g = _qkv(t + 2, 1, t, 2, 64, cuda_device)[1]
    calls = flash_attention.LANE_CALLS[lane]
    with torch.no_grad():
        out = wrapper(q, k, v)
    assert flash_attention.LANE_CALLS[lane] == calls + 1
    want, lse = plain(q, k, v, with_lse=True)
    err, ref = (out.float() - want.float()).abs(), want.float().abs()
    assert err.max() <= 2e-2 * ref.max() and err.mean() <= 7e-3 * ref.mean()
    o, w = out.double(), want.double()
    assert abs(1 - (o * w).sum() / (w * w).sum()) <= 3e-5

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    bwd = flash_attention.BWD_LAUNCHES
    grads = torch.autograd.grad(wrapper(*leaves), leaves, g)
    assert flash_attention.BWD_LAUNCHES == bwd + 1
    for x, y in zip(grads, flash_attention.flash_mha_long_bwd_plain(q, k, v, want,
                                                                    g, lse)):
        err, ref = (x.float() - y.float()).abs(), y.float().abs()
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        assert err.max() <= 2e-2 * ref.max() and err.mean() <= 1e-2 * ref.mean()


# --------------------------------------------------------------- bilateral

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f,c,view", [
    (1, 100, 5, 1, False), (2, 1100, 5, 5, False), (3, 5184, 8, 3, False),
    (1, 257, 2, 8, False), (1, 4097, 5, 5, False),
    (1, 50, 5, 9, False),      # one chunk (N <= 64), two column groups
    (16, 5184, 5, 5, True),    # q as the CRF's stream lane passes it
    (2, 5184, 5, 16, False)])  # two column groups
def test_bilateral_kernel_matches_plain(cuda_device, b, n, f, c, view):
    """Relative error max|out - plain| / max|plain| <= 1e-5 against the
    plain version run in float64 (the kernel sums squared differences in
    float32, which do not cancel; float32 rounding of the sums and exp2
    remain). Features up to |f|^2 = 1500, the CRF's own range (colours over
    srgb = 13), where the expanded distance of the float32 plain version
    cancels by up to 1.1e-4. Two calls bit-equal; the unbatched call
    bit-equal to image 0 (the column split depends on N alone). ``view``:
    q a (B, C, N) tensor transposed, read in place."""
    gen = torch.Generator().manual_seed(n + c)
    feat = torch.rand(b, n, f, generator=gen) * (1500.0 / f) ** 0.5
    feat = feat.to(cuda_device)
    q = torch.randn(b, n, c, generator=gen).to(cuda_device)
    if view:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = crf_pallas.LAUNCHES
    got = crf_pallas.bilateral_matvec_batched(feat, q)
    assert crf_pallas.LAUNCHES == before + 1
    want = crf_pallas.bilateral_matvec_plain(feat.double(), q.double())
    rel = (got.double() - want).abs().max() / want.abs().max()
    assert got.shape == (b, n, c) and rel.item() <= 1e-5
    assert torch.equal(got, crf_pallas.bilateral_matvec_batched(feat, q))
    one = crf_pallas.bilateral_matvec(feat[0], q[0])
    assert torch.equal(one, got[0])


@pytest.mark.cuda
def test_bilateral_kernel_refuses_what_it_cannot_take(cuda_device):
    """F > 8 and a q on another device are refused; any C is taken, in
    column groups of 8 (C = 9 and 16 against the float64 plain version at
    the bar of ``test_bilateral_kernel_matches_plain``)."""
    feat = torch.zeros(1, 16, 9, device=cuda_device)
    with pytest.raises(ValueError, match="<= 8"):
        crf_pallas.bilateral_matvec_batched(feat, torch.ones(1, 16, 1, device=cuda_device))
    gen = torch.Generator().manual_seed(9)
    feat = (torch.rand(1, 300, 5, generator=gen) * 300.0 ** 0.5).to(cuda_device)
    for c in (9, 16):
        q = torch.randn(1, 300, c, generator=gen).to(cuda_device)
        got = crf_pallas.bilateral_matvec_batched(feat, q)
        want = crf_pallas.bilateral_matvec_plain(feat.double(), q.double())
        rel = (got.double() - want).abs().max() / want.abs().max()
        assert got.shape == (1, 300, c) and rel.item() <= 1e-5
    with pytest.raises(ValueError, match="q on"):
        crf_pallas.bilateral_matvec_batched(feat, torch.ones(1, 300, 1))


# ---------------------------------------------------- int8 and token merging

@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [
    (64 * 325, 768, 2304), (64 * 325, 3072, 768), (64 * 133, 768, 3072),
    (5, 768, 768), (16, 768, 2304), (17, 64, 8)])
def test_int8_product_is_exact(cuda_device, rows, k, n):
    """The image tower's products at batch 64 (T = 325, and 133 after ToMe
    r = 16) and calls of 16 rows or fewer (padded with zero rows) against
    the exact integer product (float64: |sums| < 2^53)."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + k + n)
    xq = torch.randint(-127, 128, (rows, k), dtype=torch.int8,
                       device=cuda_device, generator=gen)
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                       device=cuda_device, generator=gen)
    got = quant.int8_mm(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    assert torch.equal(got.double(), xq.double() @ wq.double().t())


@pytest.mark.cuda
def test_int8_product_refuses_what_the_card_cannot_take(cuda_device):
    xq = torch.ones(20, 12, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_mm(xq, torch.ones(8, 12, dtype=torch.int8, device=cuda_device))


def _tower_images(n, size, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32))


def _cosine(a, b):
    return torch.nn.functional.cosine_similarity(
        a.double().cpu(), b.double().cpu(), dim=-1).min().item()


@pytest.mark.cuda
def test_tome_tower_on_the_card(cuda_device):
    """ViT-B/16 at 288 px, depth 3, r = 16, float32: the card against the
    CPU, and two card calls bit-equal (the merge is a one-hot product, no
    atomics); then in bf16 two calls bit-equal again."""
    cpu = build_vit("vit_base_patch16_224", 288, dict(depth=3, tome_r=16)).eval()
    card = copy.deepcopy(cpu).to(cuda_device)
    images = _tower_images(2, 288, 1)
    maps = {}

    def run(model, x):
        hook = model.blocks[-1].register_forward_hook(
            lambda m, a, out: maps.update({x.device.type: out[2]}))
        with torch.no_grad():
            out = model(x)
        hook.remove()
        return out

    want = run(cpu, images)
    got = run(card, images.to(cuda_device))
    assert (maps["cuda"].cpu() == maps["cpu"]).float().mean().item() >= 0.999
    assert _cosine(got, want) >= 0.9999
    assert torch.equal(got, run(card, images.to(cuda_device)))
    card.compute_dtype = torch.bfloat16
    with torch.no_grad():
        first = card(images.to(cuda_device))
        assert torch.equal(first, card(images.to(cuda_device)))


def _layer_inputs(vit, images):
    inputs = {}
    hooks = [layer.register_forward_pre_hook(
        lambda m, args, name=name: inputs.__setitem__(name, args[0]))
        for name, layer in quant.quant_layers(vit).items()]
    with torch.no_grad():
        tokens = vit(images)
    for h in hooks:
        h.remove()
    return tokens, inputs


def _product_io(layer, x):
    seen, real = [], quant.int8_mm

    def record(xq, wq):
        seen.append((xq, real(xq, wq)))
        return seen[-1][1]

    with unittest.mock.patch.object(quant, "int8_mm", record), torch.no_grad():
        layer(x)
    return seen[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_quant_tower_on_the_card_matches_the_cpu(cuda_device, mode):
    """ViT-B/16 at 288 px, depth 2, float32, calibrated on the CPU and
    carried to the card with the model. Each quantised layer on the CPU
    tower's input to it: int8 input codes equal on >= 99.99% of entries,
    the accumulators on the CPU's codes equal. The towers' tokens at
    per-token cosine >= 0.999: a code that moves in one layer moves its
    token's next products by a step (``chip_smoke.py:check_quant_towers``)."""
    cpu = build_vit("vit_base_patch16_224", 288, dict(depth=2, quant=mode)).eval()
    calib, images = _tower_images(2, 288, 2), _tower_images(2, 288, 3)
    quant.cache_quant_state(cpu, [lambda: cpu(calib)])
    card = copy.deepcopy(cpu).to(cuda_device)
    want, inputs = _layer_inputs(cpu, images)
    got, _ = _layer_inputs(card, images.to(cuda_device))
    card_layers = quant.quant_layers(card)
    assert len(inputs) == 2 * 4
    for name, layer in quant.quant_layers(cpu).items():
        q_cpu, acc_cpu = _product_io(layer, inputs[name])
        q_card, _ = _product_io(card_layers[name], inputs[name].to(cuda_device))
        assert (q_card.cpu() == q_cpu).float().mean().item() >= 0.9999, name
        assert torch.equal(quant.int8_mm(q_cpu.to(cuda_device),
                                         card_layers[name].weight_q).cpu(),
                           acc_cpu), name
    assert _cosine(got, want) >= 0.999


# -- image decode and resize on the card ----------------------------------------

@pytest.mark.cuda
def test_nvjpeg_decode_matches_pil_pixels(cuda_device):
    """The committed 4:2:0 JPEG through nvJPEG (planes) and libjpeg's
    upsampling and colour conversion: >= 99% of channel values within 2
    levels of PIL's decode (the IDCTs round differently), one decode
    counted; a grey JPEG comes out replicated."""
    import io
    import os

    from simseg_tpu_torch.data import image_io

    testdata = os.path.join(os.path.dirname(image_io.__file__), "_testdata")
    with open(os.path.join(testdata, "scene.jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(testdata, "scene_pil.npy")).astype(np.int32)
    before = image_io.NVJPEG_DECODES
    got = image_io.decode_rgb(data, "cuda")
    assert image_io.NVJPEG_DECODES == before + 1
    assert got.device.type == "cuda" and got.shape == want.shape
    diff = np.abs(got.cpu().numpy().astype(np.int32) - want)
    assert (diff <= 2).mean() >= 0.99
    try:
        from PIL import Image
    except ImportError:
        return
    grey = io.BytesIO()
    Image.fromarray(want[..., 1].astype(np.uint8)).save(grey, format="JPEG")
    out = image_io.decode_rgb(grey.getvalue(), "cuda").cpu()
    assert torch.equal(out[..., 0], out[..., 2])


@pytest.mark.cuda
@pytest.mark.parametrize("size,out,kind", [
    ((375, 500), (288, 288), "bilinear"), ((500, 333), (288, 288), "bilinear"),
    ((150, 200), (288, 288), "bicubic"), ((7, 800), (1, 3), "bilinear")])
def test_resize_on_the_card_is_the_cpu_resize(cuda_device, size, out, kind):
    from simseg_tpu_torch.data.transforms import pil_resize

    rng = np.random.default_rng(sum(size))
    img = torch.from_numpy(rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    assert torch.equal(pil_resize(img.cuda(), out, kind).cpu(),
                       pil_resize(img, out, kind))


@pytest.mark.cuda
def test_binary_closing_matmul_on_the_card_is_the_window_closing(cuda_device):
    """bf16 band products on the card: exact on 0/1 masks (counts <= 7)."""
    from simseg_tpu_torch.ops.morphology import binary_closing_matmul

    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.random((3, 5, 96, 80)) < 0.4).astype(np.float32))
    for k in (7, 4):
        got = binary_closing_matmul(x.cuda(), k)
        assert got.dtype == torch.float32
        assert torch.equal(got.cpu(), closing(x, k))


@pytest.mark.cuda
def test_device_prefetch_gives_the_same_run(cuda_device, tmp_path):
    """``data.device_prefetch`` 2 (pinned copies on a side stream, waited
    for by events) and 0 (each batch copied when its step starts): the same
    last loss and parameters, bit for bit, after 4 steps of a small model."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.clip.config import (task_cfg_init_fn,
                                                    update_clip_config)
    from simseg_tpu_torch.tasks.clip.train import train

    rng = np.random.default_rng(3)
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3),
                                                       dtype=np.uint8)),
                "input_ids": rng.integers(0, 60, (8, 8)).astype(np.int32),
                "attention_mask": np.ones((8, 8), np.int32)}
               for _ in range(4)]
    runs = []
    for prefetch in (0, 2):
        cfg = update_cfg(task_cfg_init_fn, None, [
            "model.image_encoder.tag=vit_test", "model.text_encoder.tag=bert_test",
            "transforms.input_size=32", "model.projection.dim=16",
            "model.max_length=8", "dist.bf16=false", "epoch=1",
            "data.train_steps=4", f"data.device_prefetch={prefetch}",
            f"ckpt.dir={tmp_path / str(prefetch)}"],
            preprocess_fn=update_clip_config, target=new_base_cfg())
        runner = train(cfg, {"train": [batches]}, device="cuda")
        runs.append((float(runner.outputs["loss"]),
                     {k: v.cpu() for k, v in runner.model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        assert torch.equal(value, runs[1][1][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_vit_block_remat_on_the_card(cuda_device, policy):
    """A ViT-B block at T = 1297 (the 576-px pass, the train lane) under
    remat: its gradients within 1e-6 of each one's largest entry of the
    un-rematerialised block's (the recompute runs the same kernels on the
    same inputs), and the train lane's forward launches doubled, the
    backward's not."""
    from simseg_tpu_torch.models.layers import remat_call
    from simseg_tpu_torch.models.vit import Block

    torch.manual_seed(0)
    block = Block(768, 12).to(cuda_device)
    x = torch.randn(2, 1297, 768, device=cuda_device).to(torch.bfloat16)
    x.requires_grad_()
    g = torch.randn_like(x)

    def grads(run):
        block.zero_grad(set_to_none=True)
        x.grad = None
        before = (flash_attention.LANE_CALLS["train"], flash_attention.BWD_LAUNCHES)
        run().backward(g)
        torch.cuda.synchronize()
        calls = (flash_attention.LANE_CALLS["train"] - before[0],
                 flash_attention.BWD_LAUNCHES - before[1])
        return calls, [x.grad.float()] + [p.grad.float() for p in block.parameters()]

    plain_calls, want = grads(lambda: block(x))
    remat_calls, got = grads(lambda: remat_call(block, policy, x, None))
    assert plain_calls == (1, 1) and remat_calls == (2, 1)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


# -- the CNN towers and the decode at their grid step ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["resnet50", "convnext_tiny", "efficientnet_b0"])
def test_cnn_tower_on_the_card_matches_the_cpu(cuda_device, tag):
    """Float32 with cuDNN's TF32 off: least per-image cosine >= 0.9999, max
    abs error <= 1e-3 of the CPU map's largest entry; BN statistics set
    from one batch first, so the seeded maps stay on scale."""
    from simseg_tpu_torch.models.cnn import build_cnn
    from simseg_tpu_torch.models.layers import BatchNorm

    torch.manual_seed(0)
    cpu = build_cnn(tag)
    x = torch.randn(4, 224, 224, 3)
    for m in cpu.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        cpu(x, train_bn=True)
        cpu.eval()
        want = cpu(x)
        card = copy.deepcopy(cpu).to(cuda_device)
        old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got = card(x.to(cuda_device)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = old
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1))
    assert cos.min().item() >= 0.9999
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["auto", "fused_tail"])
def test_decode_at_a_cnn_grid_step_matches_the_unfused_chain(cuda_device, lane):
    """Rows 1-2 at 288 px with 9 x 9 patch-grid unaries upsampled x32 (a
    CNN tower's step) against the unfused chain: pred >= 99.9%; the
    kernel launched once."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn

    rng = np.random.default_rng(32)
    b, d, c = 4, 32, 12
    dense = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(b, 81, d)).astype(np.float32)), dim=-1)
    pooled = torch.nn.functional.normalize(dense.mean(1), dim=-1)
    bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)), dim=-1)
    bank[1:4] = pooled[:3]
    rgb = torch.from_numpy(rng.integers(0, 255, (b, 288, 288, 3)).astype(np.uint8))
    args = [t.to(cuda_device) for t in (dense, pooled, bank, rgb)]
    kw = dict(num_classes=c, image_size=288, patch_size=32, top_cls_num=6)
    before = (crf_fused.LAUNCHES, crf_fused.TAIL_LAUNCHES)
    pred, _ = make_seg_decode_fn(crf_backend=lane, **kw)(*args)
    after = (crf_fused.LAUNCHES, crf_fused.TAIL_LAUNCHES)
    want, _ = make_seg_decode_fn(crf_backend="xla", **kw)(*args)
    assert (pred == want).float().mean().item() >= 0.999
    grew = (after[0] - before[0], after[1] - before[1])
    assert grew == ((1, 0) if lane == "auto" else (0, 1))


# -- the kernels as registered custom ops (simseg::) ----------------------------

def _op_cases(device):
    """(op, arguments) of every op's CUDA implementation at small shapes,
    in the layouts the main path passes (q of the bilateral product a
    transposed view)."""
    rng = np.random.default_rng(40)
    du, rgb = _case(41, 2, 3, 64, device)
    coarse = torch.from_numpy(rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
                              * 3).to(device)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 3)).astype(np.float32)).to(device)
    cand = torch.from_numpy(rng.integers(1, 20, (2, 3))).to(device)
    feat = torch.from_numpy(rng.normal(size=(2, 600, 5)).astype(np.float32)).to(device)
    qt = torch.from_numpy(rng.normal(size=(2, 5, 600)).astype(np.float32)
                          ).to(device).transpose(1, 2)
    q, k, v = _qkv(42, 2, 1100, 2, 64, device)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, True, "train")
    g = torch.randn_like(out)
    crf = (3, 3.0, 3.0, 40.0, 13.0, 10.0, 8, 7)
    return {
        "crf_mean_field": (crf_fused.crf_mean_field, (du, rgb) + crf),
        "crf_decode_tail": (crf_fused.crf_decode_tail,
                            (coarse, rgb, scores, cand, 16) + crf),
        "bilateral_matvec": (crf_pallas.bilateral_matvec_op, (feat, qt)),
        "flash_attention_fwd": (flash_attention.flash_attention_fwd,
                                (q, k, v, False, "flash")),
        "flash_attention_fwd_lse": (flash_attention.flash_attention_fwd,
                                    (q, k, v, True, "stream")),
        "flash_attention_bwd": (flash_attention.flash_attention_bwd,
                                (q, k, v, out, g, lse)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["crf_mean_field", "crf_decode_tail",
                                  "bilateral_matvec", "flash_attention_fwd",
                                  "flash_attention_fwd_lse",
                                  "flash_attention_bwd"])
def test_opcheck_cuda_implementation(cuda_device, name):
    """``torch.library.opcheck`` of each op's CUDA implementation: schema,
    fake tensor (shapes, dtypes and strides of the kernel's outputs),
    autograd registration and AOT dispatch."""
    op, args = _op_cases(cuda_device)[name]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("crf_backend", ["auto", "fused_tail"])
def test_loaded_artifact_counts_its_launches(cuda_device, tmp_path, crf_backend):
    """A seg artifact exported on the card (the tiny CLIP at 32 px) and
    loaded: its calls equal the live call's bit for bit, and each launches
    the CRF kernel (or the tail kernel) once, counted at run time inside
    the op."""
    from simseg_tpu_torch import serving
    from simseg_tpu_torch.models.clip import CLIPModel
    from simseg_tpu_torch.utils.collections import AttrDict

    torch.manual_seed(0)
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16, image_k=3)
    cfg = AttrDict()
    cfg.transforms = AttrDict(input_size=32, normalize=AttrDict(
        mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]))
    cfg.seg_eval = AttrDict(bilateral_stride=4, crf_backend=crf_backend)
    rng = np.random.default_rng(9)
    bank = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    fn = serving.make_seg_infer_fn(model, bank, cfg, num_classes=5,
                                   top_cls_num=3, device=cuda_device)
    x = torch.from_numpy(rng.integers(0, 255, (4, 32, 32, 3)).astype(np.uint8)
                         ).to(cuda_device)
    path = str(tmp_path / "seg.pt2")
    serving.save_artifact(path, serving.export_artifact(fn, (x,)))
    loaded = serving.load_artifact(path)
    attr = "LAUNCHES" if crf_backend == "auto" else "TAIL_LAUNCHES"
    live = fn(x)
    before = getattr(crf_fused, attr)
    got = [loaded(x) for _ in range(2)]
    torch.cuda.synchronize()
    assert getattr(crf_fused, attr) == before + 2
    for out in got:
        assert all(torch.equal(a, b) for a, b in zip(out, live))
