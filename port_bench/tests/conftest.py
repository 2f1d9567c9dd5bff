"""The benchmark's own tests: the harness on the CPU at test sizes (the
tiny configuration and traffic under ``data/``), its arithmetic, and, on a
card only, the controls at the cells' own sizes. Run from the checkout's
root: ``python -m pytest port_bench/tests``."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def tiny():
    """run(cell, **kw) -> the result of one CPU run of a test cell."""
    from pbench import harness, manifest

    man = manifest.read_json(os.path.join(HERE, "data", "manifest.json"))

    def run(name, seconds=0.5, trace=False, fault=None, variant=None, seed=987654321012):
        cell = manifest.Cell(ROOT, man, name, where=os.path.join(HERE, "data"))
        return harness.run_cell(ROOT, name, seed, seconds, trace, device="cpu",
                                cell=cell, fault=fault, variant=variant)
    return run


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run only there")
    return torch.device("cuda")


def read(path):
    with open(path) as f:
        return json.load(f)
