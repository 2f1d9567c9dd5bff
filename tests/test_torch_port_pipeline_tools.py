"""PyTorch port (simseg_tpu_torch): the pipeline tools
(``simseg_tpu_torch/tools/benchmark_{input,train}_pipeline.py``) against
JAX's ``tools/`` counterparts on the CPU.

- ``make_shard`` writes JAX's bytes (3 images of 64 x 48), and ``build_cfg``
  JAX's config leaves;
- the input pipeline's ``main`` prints JAX's JSON keys for the PIL lane
  and, where the native library is off, the native lane's reason and no
  number;
- the train pipeline's override list is JAX's, and its
  ``main`` runs 2 steps on a runner shrunk to the test towers, printing
  JAX's keys.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from simseg_tpu_torch.tools import benchmark_input_pipeline as input_pipeline
from simseg_tpu_torch.tools import benchmark_train_pipeline as train_pipeline
from tools import benchmark_input_pipeline as jax_input_pipeline

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_make_shard_writes_jax_bytes(tmp_path):
    input_pipeline.make_shard(str(tmp_path / "port"), 3, 64, 48)
    jax_input_pipeline.make_shard(str(tmp_path / "jax"), 3, 64, 48)
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == ["bench/train/00000.jpg", "bench/train/00001.jpg",
                            "bench/train/00002.jpg", "bench/train_anno.csv"]
    assert port == jax


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], list(tree) if isinstance(tree, tuple) else tree


@pytest.mark.parametrize("native", [False, True])
def test_build_cfg_leaves_are_jax(native):
    args = ("/data/", ["random_resize_crop", "autoaug"], 64, 4, native)
    port = dict(_leaves(input_pipeline.build_cfg(*args)))
    jax = dict(_leaves(jax_input_pipeline.build_cfg(*args)))
    assert port == jax


def test_input_pipeline_prints_jax_keys(monkeypatch, capsys):
    from simseg_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "off for the test")
    results = input_pipeline.main(["--device", "cpu", "--images", "8",
                                   "--batch_size", "4", "--workers", "2",
                                   "--size", "64,48"])
    assert list(results) == ["pil_w2"] and results["pil_w2"] > 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0] == {"decode": "native", "img_per_sec": None,
                        "reason": "the native library is unavailable: off "
                                  "for the test", "card": "cpu, host clock"}
    assert set(lines[1]) - {"card"} == {"decode", "workers", "img_per_sec",
                                        "transforms", "src_size"}
    assert lines[1]["transforms"] == ["random_resize_crop", "autoaug"]
    assert lines[2] == {"summary": results, "card": "cpu, host clock"}


def _jax_overrides():
    """JAX's override list (``tools/benchmark_train_pipeline.py:48-83``)
    with the f-strings' fields as placeholders."""
    with open(os.path.join(ROOT, "tools", "benchmark_train_pipeline.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "argv":
            return [ast.unparse(e) for e in node.value.elts]
    raise AssertionError("no argv list in JAX's tool")


def test_train_pipeline_overrides_are_jax():
    port = train_pipeline.overrides("{root}", "{batch}", "{steps}",
                                    "{workers}", "{prefetch}")
    jax = [e[2:-1] if e.startswith("f'") else e[1:-1] for e in _jax_overrides()]
    assert port == jax


TINY = ("model.image_encoder.tag=vit_test", "model.text_encoder.tag=bert_test",
        "model.projection.dim=16", "model.pool.name=loda",
        "model.pool.loda.image_k=3", "model.pool.loda.text_k=1")


def test_train_pipeline_runs_a_shrunk_runner(monkeypatch, capsys):
    monkeypatch.setattr(train_pipeline, "MODEL", TINY)
    monkeypatch.setattr(train_pipeline, "SIZE", 32)
    out = train_pipeline.main(["--device", "cpu", "--batch", "4", "--steps",
                               "2", "--images", "4", "--workers", "2",
                               "--size", "64,48"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed == out
    assert set(out) == {"batch", "steps", "img_per_s", "real_over_synthetic",
                        "card"}
    assert (out["batch"], out["steps"]) == (4, 2)
    assert set(out["img_per_s"]) == {"real_prefetch2", "real_prefetch0",
                                     "synthetic"}
    assert all(np.isfinite(v) and v > 0 for v in out["img_per_s"].values())
    assert out["real_over_synthetic"] > 0
