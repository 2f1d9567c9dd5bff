"""PyTorch port (simseg_tpu_torch): the CRF kernel's launch plan
(``ops/crf_fused.launch_plan``) on the CPU, for every shape the decode sends
to the kernel (``fused_eligible``). The plan mirrors ``smem_need`` and
``tile_layout`` of ``csrc/crf_mean_field.cu``, which refuses a plan short of
its own count; here it is held to the 232,448 bytes of shared memory a block
may take on sm_90 and to update tiles of whole stride cells."""

import os
import re

import pytest

from simseg_tpu_torch.ops import crf_fused
from simseg_tpu_torch.ops.cuda_build import CSRC


def _eligible(stride):
    """Every (h, w) that fused_eligible admits at this stride."""
    top = 512 // stride
    return [(gh * stride, gw * stride) for gh in range(1, top + 1)
            for gw in range(1, top + 1)
            if crf_fused.fused_eligible(gh * stride, gw * stride, stride)]


def _check(h, w, stride):
    for tail in (False, True):
        # the widest radius and class count; the closing as the decode runs
        # it, and wider than any band
        for ck in (7, 2 * max(h, w) + 1):
            plan = crf_fused.launch_plan(h, w, stride, 16, 8, 3, ck, tail)
            assert 0 < plan.smem_bytes <= crf_fused.SMEM_LIMIT, (h, w, stride, ck)
            assert 1 <= plan.tile_h <= 32 and 1 <= plan.tile_w <= 64
            if stride <= 32:
                assert plan.fused_splat
                assert plan.tile_h % stride == 0 and plan.tile_w % stride == 0
            else:
                assert not plan.fused_splat


@pytest.mark.parametrize("stride", range(1, 17))
def test_plan_fits_every_eligible_shape(stride):
    shapes = _eligible(stride)
    assert shapes
    for h, w in shapes:
        _check(h, w, stride)


def test_plan_fits_every_eligible_shape_at_wide_strides():
    for stride in range(17, 513):
        for h, w in _eligible(stride):
            _check(h, w, stride)


def test_main_path_plan():
    """288^2, stride 8, radius 9, K = 5: 32 x 64 tiles of whole cells; the
    update tile (50 rows of 83 + 65 floats, its normalisations and halo
    offsets by row and column, its rows' cell offsets, the 33 taps' room
    and the tile's unaries) is the largest part."""
    plan = crf_fused.launch_plan(288, 288, 8, 9, 5, 3, 7)
    assert plan == crf_fused.LaunchPlan(
        32, 64, True, 4 * (50 * 148 + 2 * 50 + 2 * 82 + 32 + 33 + 32 * 64))
    n = 36 * 36
    assert crf_fused.workspace_floats(16, 5, 288, 288, 8) == (
        16 * n * 8 + 16 * n + 2 * 16 * 5 * n + 2 * 16 * 5 * 288 * 288
        + 16 * 5 * 288 * 9)


def test_plan_constants_match_the_kernel_source():
    """The plan's cuts are the kernel's constants (its source and the
    header both CRF sources share)."""
    src = ""
    for name in ("crf_mean_field.cu", "crf_common.cuh"):
        with open(os.path.join(CSRC, name)) as f:
            src += f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert const("kMaxTileH") == crf_fused._TILE_H
    assert const("kMaxTileW") == crf_fused._TILE_W
    assert const("kStrip") == crf_fused._STRIP
    assert const("kChunk") == crf_fused._CHUNK
    assert const("kBand") == crf_fused._BAND
    assert const("kSmemLimit") == crf_fused.SMEM_LIMIT
    assert const("kMaxClasses") == crf_fused._MAX_CLASSES
    assert const("kMaxRadius") == crf_fused._MAX_RADIUS
    assert const("kThreads") // 32 == crf_fused._WARPS
