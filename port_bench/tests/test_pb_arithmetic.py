"""The frozen arithmetic against hand counts: flops and the mean."""

import pytest

from pbench import stats, yardstick as ys


def test_tower_flops_by_hand():
    # one block, t = 2, d = 3: 12*2*9 + 2*4*3 = 240 MACs, 480 flops
    assert ys.tower_flops(2, 3, 1) == 480.0
    assert ys.tower_flops(2, 3, 2, extra_macs=10) == 2 * (480 + 10)


def test_train_pair_flops_by_hand():
    img = ys.tower_flops(197, 768, 12, 196 * 768 * 768 + 196 * 768 * 512)
    txt = ys.tower_flops(25, 768, 12, 25 * 768 * 512)
    got = ys.clip_pair_train_flops(224, 16, 768, 12, 25, 768, 12, 512)
    assert got == pytest.approx(3 * (img + txt))
    assert 100e9 < got < 130e9


def test_mean_of_every_sample():
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0
    with pytest.raises(ValueError):
        stats.mean([])
