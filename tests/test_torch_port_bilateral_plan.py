"""PyTorch port (simseg_tpu_torch): the bilateral kernel's launch plan
(``ops/crf_pallas.launch_plan``) on the CPU, for every N the CRF's stream
lane sends to the kernel (4097 to 16384 cells: 128 x 128 cells, a 1024-px
map at stride 8) at B = 1, 16 and 64. The plan mirrors the checks of
``bilateral_matvec_f32`` in ``csrc/bilateral_matvec.cu``, which refuses a
plan short of its own count. Held here: the row tiles and the column chunks
each cover [0, N) once; the rows computed past N (a warp holds 192 rows)
are under 4.7% of N; the chunks depend on N alone, so an image's sums are
taken in the same order at every batch; one image's grid has at least 132
CTAs (the H100's SMs); shared memory fits the 232,448 bytes a block may
take; the workspace holds the (G, B, S, CW, N) partial sums the kernel
writes."""

import os
import re

import pytest

from simseg_tpu_torch.ops import crf_pallas
from simseg_tpu_torch.ops.cuda_build import CSRC

STREAM_NS = range(4097, 128 * 128 + 1)
SMEM_LIMIT = 232448


def _covers_once(n, parts, size):
    """[0, n) in ``parts`` pieces of ``size`` (the last one cut at n):
    every piece starts below n and the pieces reach n."""
    return (parts - 1) * size < n <= parts * size


@pytest.mark.parametrize("b", [1, 16, 64])
def test_plan_covers_every_stream_n(b):
    for n in STREAM_NS:
        plan = crf_pallas.launch_plan(b, n, 5, 5)
        rows = plan.warps * crf_pallas._WARP_ROWS
        assert _covers_once(n, plan.row_tiles, rows), (b, n)
        assert _covers_once(n, plan.chunks, plan.chunk_cells), (b, n)
        assert plan.chunk_cells >= crf_pallas._TILE
        # as the kernel does: a warp whose first row is below N computes
        # all 192 of its rows, a warp past N none
        bases = range(0, plan.row_tiles * rows, crf_pallas._WARP_ROWS)
        computed = sum(crf_pallas._WARP_ROWS for base in bases if base < n)
        assert 0 <= computed - n < 0.047 * n, (b, n)
        assert plan.grid == (plan.row_tiles * plan.chunks, b, 1)


def test_chunks_depend_on_n_alone():
    for n in STREAM_NS:
        plans = [crf_pallas.launch_plan(b, n, 5, c)
                 for b in (1, 16, 64) for c in (1, 5)]
        assert len({(p.chunks, p.chunk_cells) for p in plans}) == 1, n


def test_one_image_fills_the_card():
    for n in STREAM_NS:
        plan = crf_pallas.launch_plan(1, n, 5, 5)
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 132, n


@pytest.mark.parametrize("f,c", [(5, 1), (5, 5), (2, 3), (8, 8), (5, 9),
                                 (3, 16), (5, 17)])
def test_smem_and_workspace_match_the_kernel(f, c):
    """Records of F features (8 where F != 5) and up to 8 columns, padded
    to 4 floats, in two stages of 64 cells; partial sums (G, B, S, CW, N)
    with G = ceil(C / 8) column groups of CW = min(C, 8)."""
    for b in (1, 16, 64):
        for n in (4097, 5184, 7919, 16384):
            plan = crf_pallas.launch_plan(b, n, f, c)
            fk = 5 if f == 5 else 8
            cw = min(c, 8)
            record = -(-(fk + cw) // 4) * 4
            assert plan.smem_bytes == 2 * 64 * record * 4 <= SMEM_LIMIT
            assert plan.groups == -(-c // 8)
            assert plan.grid[2] == plan.groups
            assert plan.workspace_floats == plan.groups * b * plan.chunks * cw * n


def test_main_path_plan():
    """(16, 5184) cells at F = C = 5, the window slice's call: 27 warps of
    192 rows (no row past N) in 7 CTAs of 4, 20 chunks of 260 cells, 2240
    CTAs; one image's grid 140 CTAs."""
    plan = crf_pallas.launch_plan(16, 5184, 5, 5)
    assert plan == crf_pallas.LaunchPlan(4, 7, 20, 260, 1, (140, 16, 1),
                                         2 * 64 * 12 * 4, 16 * 20 * 5 * 5184)
    assert crf_pallas.launch_plan(1, 5184, 5, 1).grid == (140, 1, 1)


def test_small_n_takes_one_chunk():
    """Below 64 cells there is one chunk; its partial sums still go through
    the workspace, and the chunk sum copies them to the output."""
    plan = crf_pallas.launch_plan(3, 50, 5, 2)
    assert plan.chunks == 1 and plan.chunk_cells >= 50
    assert plan.workspace_floats == 3 * 1 * 2 * 50


def test_plan_constants_match_the_kernel_source():
    """The plan's cuts are the kernel's constants."""
    with open(os.path.join(CSRC, "bilateral_matvec.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert 32 * const("kRows") == crf_pallas._WARP_ROWS
    assert const("kTile") == crf_pallas._TILE
    assert const("kStages") == crf_pallas._STAGES
    assert const("kGroup") == crf_pallas._GROUP
    assert const("kMaxFeat") == crf_pallas._MAX_F
    assert crf_pallas._WARPS <= const("kMaxWarps")
