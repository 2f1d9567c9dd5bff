"""The entry's refusals: no card, no result; JAX or the JAX package
loaded, no result; a checkout holding only the benchmark, no result."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from conftest import ROOT
from pbench import harness

CELL = "vitb16.train.224.b256"


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_fails_without_a_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("name, caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("simseg_tpu", True), ("simseg_tpu.ops.crf", True),
    ("simseg_tpu_torch", False), ("simseg_tpu_torch.ops.crf", False),
    ("jaxtyping", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for m in list(sys.modules):
        if m.split(".")[0] in harness.FORBIDDEN and m != name:
            monkeypatch.delitem(sys.modules, m)
    assert (name.split(".")[0] in harness.forbidden_modules()) is caught


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = ['port_bench', '.']; "
            "import pbench.harness, pbench.program, pbench_ref.train; "
            "import simseg_tpu_torch.engine.train_step, "
            "simseg_tpu_torch.core.optim, simseg_tpu_torch.models.clip; "
            "from pbench.harness import forbidden_modules; print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, USE_FLAX="0"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
