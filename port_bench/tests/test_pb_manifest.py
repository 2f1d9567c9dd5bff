"""BENCHMARK.json and the test manifest keep to the contract; a name, a
unit, a bound or a key outside it is caught; every cell finds its files."""

import copy
import os

import pytest

from conftest import HERE, ROOT, read
from pbench import manifest


def test_benchmark_json_is_sound():
    man = manifest.load(ROOT)
    assert manifest.check(man, ROOT) == []


def test_test_manifest_is_sound():
    man = read(os.path.join(HERE, "data", "manifest.json"))
    bad = manifest.check(man, ROOT)
    # the test cells' traffic and limits live under tests/data, not in the
    # benchmark's folders
    assert all("no traffic/" in b or "no limits/" in b for b in bad), bad


@pytest.mark.parametrize("path, value, needle", [
    (("workloads", 0, "name"), "has space", "name"),
    (("workloads", 0, "name"), "a/b", "name"),
    (("workloads", 0, "name"), "x" * 65, "name"),
    (("end_to_end", 0, "unit"), "images per second", "unit"),
    (("end_to_end", 0, "bound"), 0.3, "bound"),
    (("end_to_end", 0, "bound"), 0.005, "bound"),
    (("run_seconds",), 52, "run_seconds"),
    (("workloads", 0, "chips"), 2, "chips"),
    (("configs", 0, "reduced"), ["hidden_size"], "reduces"),
    (("configs", 0, "reduced"), ["model.projection.dim"], "reduces"),
    (("per_layer", 0, "moves"), "nope", "moves"),
    (("per_layer", 0, "source"), "guess", "source"),
    (("command",), ["python3", "/abs/run.py"], "leaves"),
])
def test_a_broken_field_is_caught(path, value, needle):
    man = copy.deepcopy(manifest.load(ROOT))
    node = man
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    assert any(needle in b for b in manifest.check(man, ROOT))


def test_an_extra_key_is_caught():
    man = copy.deepcopy(manifest.load(ROOT))
    man["per_layer"][0]["why"] = "not allowed"
    assert manifest.check(man, ROOT)


def test_setup_s_is_required():
    man = copy.deepcopy(manifest.load(ROOT))
    man["end_to_end"] = [m for m in man["end_to_end"] if m["name"] != "setup_s"]
    assert any("setup_s" in b for b in manifest.check(man, ROOT))


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load(ROOT)["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = manifest.Cell(ROOT, manifest.load(ROOT), cell)
    assert c.traffic["kind"] == "clip_train"
    assert c.limits["checks"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer
    assert set(c.config["sizes"]) == {"image", "text", "proj_dim"}


def test_reported_follows_workloads_and_moves():
    man = manifest.load(ROOT)
    cell = man["workloads"][0]["name"]
    names = {m["name"] for m in man["per_layer"] if manifest.reported(m, cell, man)}
    assert names == {m["name"] for m in man["per_layer"]
                     if cell in m.get("workloads", [cell])}
    other = {"name": "x", "moves": "setup_s"}
    assert manifest.reported(other, cell, man)
    assert not manifest.reported({"name": "x", "moves": "nope"}, cell, man)
