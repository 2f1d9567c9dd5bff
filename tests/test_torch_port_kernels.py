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
"""

import numpy as np
import pytest
import torch

from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention
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
