"""PyTorch port (simseg_tpu_torch): the bf16 CRF kernel's launch plan
(``ops/crf_fused.launch_plan_bf16``) and workspace
(``workspace_bytes_bf16``) on the CPU, for every shape the decode sends to
the bf16 lanes: 288^2 maps at stride 8 with 1-8 candidate maps and 0-3
iterations, the mean field and the tails of the x16 (ViT-B/16) and x32
(ResNet-50) patch grids, and every ``fused_eligible`` shape at the widest
radius and class count. The plan mirrors ``smem_need`` and ``tile_layout``
of ``csrc/crf_mean_field_bf16.cu``, which refuses a plan or a workspace
short of its own count; here the plan is held to the 232,448 bytes of
shared memory a block may take on sm_90 and to update tiles of whole stride
cells, and the workspace to holding no (B, N, N) buffer."""

import numpy as np
import pytest

from simseg_tpu_torch.ops import crf_fused

SIZE, STRIDE = 288, 8


def _parts(b, k, h, w, stride):
    """The workspace's parts in bytes, unaligned: features by cell pair,
    bn, m, bn q, two bf16 iterates, the mask bits."""
    n = (h // stride) * (w // stride)
    npad = -(-n // 16) * 16
    return (b * npad * 6 * 4, b * npad * 4, b * k * n * 4, b * npad * 8 * 2,
            2 * b * k * h * (w + w % 2) * 2, b * k * h * -(-w // 32) * 4)


@pytest.mark.parametrize("tail,factor", [(False, 1), (True, 16), (True, 32)])
@pytest.mark.parametrize("k", range(1, 9))
def test_plan_and_workspace_of_the_decode_shapes(tail, factor, k):
    """288^2 at stride 8 (the patch grid 18 x 18 at x16, 9 x 9 at x32):
    tiles of whole cells with the splat fused, the closing as the decode
    runs it, shared memory under the limit, two blocks a multiprocessor;
    the workspace is its parts, each 256-aligned, and far below one bf16
    (B, N, N) matrix."""
    assert SIZE % factor == 0
    for iters in range(4):
        plan = crf_fused.launch_plan_bf16(SIZE, SIZE, STRIDE, 9, k, iters, 7,
                                          tail)
        assert (plan.tile_h, plan.tile_w, plan.fused_splat) == (32, 64, True)
        assert plan.tile_h % STRIDE == 0 and plan.tile_w % STRIDE == 0
        assert 0 < plan.smem_bytes <= crf_fused.SMEM_LIMIT // 2
    n = (SIZE // STRIDE) ** 2
    for b in (1, 16, 64):
        got = crf_fused.workspace_bytes_bf16(b, k, SIZE, SIZE, STRIDE)
        parts = _parts(b, k, SIZE, SIZE, STRIDE)
        assert sum(parts) <= got < sum(parts) + 256 * len(parts)
        assert got < b * n * n * 2


def test_workspace_holds_no_cell_by_cell_buffer():
    """Quartering the stride's cell area (4x the cells) adds only the
    per-cell parts: no term grows as N^2."""
    b, k = 16, 5
    coarse = crf_fused.workspace_bytes_bf16(b, k, SIZE, SIZE, 8)
    fine = crf_fused.workspace_bytes_bf16(b, k, SIZE, SIZE, 4)
    cells = (SIZE // 4) ** 2 - (SIZE // 8) ** 2
    assert 0 < fine - coarse <= b * cells * (24 + 4 + 4 * k + 16) + 6 * 256


def test_main_path_plan():
    """288^2, stride 8, radius 9, K = 5: 32 x 64 tiles; the update tile is
    the largest part: the bf16 halo (50 rows of 86 values, 43 words), the
    row pass's sums (50 x 65) and the new d (32 x 65)."""
    plan = crf_fused.launch_plan_bf16(SIZE, SIZE, STRIDE, 9, 5, 3, 7)
    words = 50 * 43 + 50 * 65 + 32 * 65
    assert plan == crf_fused.LaunchPlan(32, 64, True, 4 * words)
    assert plan.smem_bytes == 29920


@pytest.mark.parametrize("h,w,sxy", [(288, 288, 3.0), (96, 160, 3.0),
                                     (16, 40, 3.0), (288, 288, 5.0)])
def test_kernel_tables(h, w, sxy):
    """The tables as the kernel reads them: bf16_tables rounded to bf16,
    each row zero-padded to a float4, 8 zero rows after the map's; the
    interior range holds the middle row's taps, its neighbours outside do
    not, and at 288^2 (radius 9) it covers every column whose band and
    normalisations lie inside the map, [2r, 287 - 2r]."""
    wt, ht, (wlo, whi, hlo, hhi) = crf_fused.kernel_tables(h, w, sxy)
    r = int(np.ceil(3 * sxy))
    for tab, want, n, lo, hi in ((wt, 0, w, wlo, whi), (ht, 1, h, hlo, hhi)):
        src = crf_fused.to_bf16(crf_fused.bf16_tables(h, w, sxy)[want]).float().numpy()
        assert tab.dtype == np.float32 and tab.shape == (n + 8, -(-(2 * r + 1) // 4) * 4)
        np.testing.assert_array_equal(tab[:n, :2 * r + 1], src)
        assert not tab[n:].any() and not tab[:, 2 * r + 1:].any()
        assert 0 <= lo <= n // 2 <= hi < n
        assert (tab[lo:hi + 1] == tab[n // 2]).all()
        for edge in (lo - 1, hi + 1):
            if 0 <= edge < n:
                assert not (tab[edge] == tab[n // 2]).all()
        if (h, w, sxy) == (288, 288, 3.0):
            assert lo <= 2 * r and hi >= n - 1 - 2 * r


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16, 32, 48, 64])
def test_plan_fits_every_eligible_shape(stride):
    """Every (h, w) that fused_eligible admits, at the widest radius and
    class count, with the decode's closing and one wider than any band."""
    top = 512 // stride
    shapes = [(gh * stride, gw * stride) for gh in range(1, top + 1)
              for gw in range(1, top + 1)
              if crf_fused.fused_eligible(gh * stride, gw * stride, stride)]
    assert shapes
    for h, w in shapes:
        for tail in (False, True):
            for ck in (7, 2 * max(h, w) + 1):
                plan = crf_fused.launch_plan_bf16(h, w, stride, 16, 8, 3, ck,
                                                  tail)
                assert 0 < plan.smem_bytes <= crf_fused.SMEM_LIMIT
                assert 1 <= plan.tile_h <= 32 and 1 <= plan.tile_w <= 64
                assert plan.fused_splat == (stride <= 32)
                if plan.fused_splat:
                    assert plan.tile_h % stride == 0 and plan.tile_w % stride == 0
