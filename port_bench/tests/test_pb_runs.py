"""Whole runs of the test cell on the CPU (the look for a card skipped):
sound runs come out correct with every metric the cell reports; each
fault the cell can have, planted under the timed path, and the control in
the program's place come out not correct."""

import math

import pytest

SEEDS = [987654321012, 2 ** 31 + 77]


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(tiny, seed):
    out = tiny("tiny.train", seed=seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    assert names == {"setup_s", "train_images_per_s"}
    for m in out["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


def test_a_traced_run_reports_its_host_metrics_and_a_breakdown(tiny):
    out = tiny("tiny.train", trace=True)
    assert out["correct"]
    assert {"train.host_ms", "mfu.train"} <= set(out["metrics"])
    # the CPU has no device trace: no device metric is written for it
    assert not any(k.startswith("idle.") for k in out["metrics"])
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_grad"])
def test_a_planted_fault_is_not_correct(tiny, fault):
    out = tiny("tiny.train", fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_in_the_programs_place_is_not_correct(tiny, seed):
    out = tiny("tiny.train", variant="fp8", seed=seed)
    assert not out["correct"], out["checks"]


def test_the_same_seed_gives_the_same_answers(tiny):
    a = tiny("tiny.train", seed=5)
    b = tiny("tiny.train", seed=5)
    assert a["checks"] == b["checks"]
