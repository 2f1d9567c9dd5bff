"""The training cell at its own size, on the card only (``cuda``): a sound
run is correct; the fp8 control in the program's place is not, nor is
each fault planted under the timed step (half the batch, the text
projection's gradient doubled, the state left unchanged). About half a
minute a run:

    python -m pytest -m cuda port_bench/tests/test_pb_card.py
"""

import pytest

from conftest import ROOT
from pbench import harness, manifest

CELL = "vitb16.train.224.b256"
SEEDS = (2 ** 32 + 101, 2 ** 32 + 202, 2 ** 32 + 303)


def _run(seed, **kw):
    c = manifest.Cell(ROOT, manifest.load(ROOT), CELL)
    return harness.run_cell(ROOT, CELL, seed, 3.0, False, device="cuda", cell=c, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_step_is_correct(card, seed):
    out = _run(seed)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_in_the_programs_place_is_not_correct(card, seed):
    out = _run(seed, variant="fp8")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half_batch", "altered_grad", "unchanged_state"])
def test_a_planted_fault_is_not_correct(card, fault):
    assert not _run(SEEDS[0], fault=fault)["correct"]
