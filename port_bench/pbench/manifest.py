"""``BENCHMARK.json``: loading a cell by name, and the checks of the
benchmark's contract that a file can fail before any run.

A cell names its configuration and its traffic; the harness finds the
configuration's file by the manifest, the traffic at
``port_bench/traffic/<traffic>.json``, the cell's limits at
``port_bench/limits/<cell>.json``, each metric's reader at
``port_bench/metrics/<metric>.py`` and the traffic's kind at
``port_bench/kinds/<kind>.py``. Adding a cell, a mix or a metric is
adding files and entries.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# words of a name that make a key a width, which ``reduced`` may not name
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "dim",
               "rank", "head", "expansion", "ratio", "experts_per_tok",
               "width", "embed", "mlp", "inter")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload with its configuration, traffic, limits and metrics."""

    def __init__(self, root: str, manifest: dict, name: str,
                 where: str = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.root = root
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = read_json(os.path.join(
            where, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = read_json(os.path.join(where, "limits", f"{name}.json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if reported(m, name, manifest)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if reported(m, name, manifest)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def reported(metric: dict, cell: str, manifest: dict) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``; without the key, an end-to-end metric is every cell's,
    and a per-layer one every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = [m for m in manifest["end_to_end"] if m["name"] == metric["moves"]]
    return bool(moved) and reported(moved[0], cell, manifest)


def _one_line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def check(manifest: dict, root: str) -> List[str]:
    """The contract's rules a file can break, as messages (none: sound)."""
    bad: List[str] = []
    if set(manifest) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(manifest)} != {sorted(TOP_KEYS)}")
        return bad
    paths = manifest["paths"]
    if not 1 <= len(paths) <= 16 or not all(
            isinstance(p, str) and PATH.match(p) and not p.startswith("/")
            and ".." not in p.split("/") for p in paths):
        bad.append(f"paths {paths}")
    cmd = manifest["command"]
    if not (1 <= len(cmd) <= 32 and all(_one_line(w) for w in cmd)):
        bad.append("command words")
    for w in cmd:
        if w.startswith("/") or ".." in w.split("/"):
            bad.append(f"command word {w!r} leaves the checkout")
        elif os.path.exists(os.path.join(root, w)) and "/" in w and not any(
                w == p or w.startswith(p.rstrip("/") + "/") for p in paths):
            bad.append(f"command names {w!r} outside paths")
    rs = manifest["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        bad.append(f"run_seconds {rs}")
    elif (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 > 43200:
        bad.append(f"run_seconds {rs}: 24 cells do not fit the check")
    names = set()

    def named(entry, kind):
        n = entry.get("name", "")
        if not NAME.match(n):
            bad.append(f"{kind} name {n!r}")
        if n in names:
            bad.append(f"{kind} name {n!r} twice")
        names.add(n)

    configs = manifest["configs"]
    if not 1 <= len(configs) <= 24:
        bad.append("1-24 configs")
    files = set()
    for c in configs:
        named(c, "config")
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')} keys {sorted(c)}")
            continue
        if not (_one_line(c["source"]) and _one_line(c["why"])):
            bad.append(f"config {c['name']} source / why")
        if c["file"] in files or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            bad.append(f"config {c['name']} file {c['file']}")
        files.add(c["file"])
        if not os.path.exists(os.path.join(root, c["file"])):
            bad.append(f"config file {c['file']} missing")
        if len(c["reduced"]) > 16:
            bad.append(f"config {c['name']} reduces over 16 keys")
        for k in c["reduced"]:
            low = k.lower()
            if not NAME.match(k) or any(w in low for w in WIDTH_WORDS) or low.endswith(("_dim", "_rank")):
                bad.append(f"config {c['name']} reduces {k!r}")
    cells = manifest["workloads"]
    if not 1 <= len(cells) <= 24:
        bad.append("1-24 workloads")
    pairs, used = set(), set()
    for w in cells:
        named(w, "workload")
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')} keys {sorted(w)}")
            continue
        if w["config"] not in {c["name"] for c in configs}:
            bad.append(f"workload {w['name']} config {w['config']}")
        if not NAME.match(w["traffic"]) or not NAME.match(w["config"]):
            bad.append(f"workload {w['name']} traffic / config name")
        if (w["config"], w["traffic"]) in pairs:
            bad.append(f"workload {w['name']}: its pair twice")
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        if w["chips"] not in (1, 4) or not _one_line(w["why"]):
            bad.append(f"workload {w['name']} chips / why")
        for sub, name in (("traffic", f"{w['traffic']}.json"),
                          ("limits", f"{w['name']}.json")):
            if not os.path.exists(os.path.join(HERE, sub, name)):
                bad.append(f"workload {w['name']}: no {sub}/{name}")
    if sum(w.get("chips") == 4 for w in cells) > max(1, len(cells) // 4):
        bad.append("too many four-chip cells")
    for c in configs:
        if c["name"] not in used:
            bad.append(f"config {c['name']} used by no cell")
    e2e = manifest["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        bad.append("1-16 end-to-end metrics")
    if "setup_s" not in {m.get("name") for m in e2e}:
        bad.append("no setup_s")
    for m in e2e:
        named(m, "metric")
        keys = set(m) - {"workloads"}
        if keys != {"name", "unit", "better", "bound", "source"}:
            bad.append(f"metric {m.get('name')} keys {sorted(m)}")
            continue
        if m["source"] not in ("host_clock", "device_trace"):
            bad.append(f"metric {m['name']} source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            bad.append(f"metric {m['name']} bound {m['bound']}")
    layer = manifest["per_layer"]
    if not 1 <= len(layer) <= 128:
        bad.append("1-128 per-layer metrics")
    e2e_names = {m.get("name") for m in e2e}
    for m in layer:
        named(m, "metric")
        keys = set(m) - {"workloads"}
        if keys != {"name", "unit", "better", "source", "layer", "moves"}:
            bad.append(f"metric {m.get('name')} keys {sorted(m)}")
            continue
        if m["source"] not in SOURCES or not _one_line(m["layer"]):
            bad.append(f"metric {m['name']} source / layer")
        if m["moves"] not in e2e_names:
            bad.append(f"metric {m['name']} moves {m['moves']}")
    for m in e2e + layer:
        if "unit" in m and not UNIT.match(m["unit"]):
            bad.append(f"metric {m.get('name')} unit {m['unit']!r}")
        if m.get("better") not in ("lower", "higher"):
            bad.append(f"metric {m.get('name')} better")
        for w in m.get("workloads", []):
            if w not in {c["name"] for c in cells}:
                bad.append(f"metric {m['name']} lists {w}")
        if not os.path.exists(os.path.join(HERE, "metrics", f"{m.get('name')}.py")):
            bad.append(f"metric {m.get('name')}: no reader")
    by_name = {m["name"]: m for m in e2e if "name" in m}
    for w in cells:
        n = w.get("name")
        got = [m["name"] for m in e2e if reported(m, n, manifest)]
        if "setup_s" not in got or len(got) < 2:
            bad.append(f"workload {n} reports {got}")
        if not any(reported(m, n, manifest) for m in layer):
            bad.append(f"workload {n} reports no per-layer metric")
        for m in layer:
            if (reported(m, n, manifest) and m.get("moves") in by_name
                    and not reported(by_name[m["moves"]], n, manifest)):
                bad.append(f"workload {n}: {m['name']} moves a metric it does not report")
    if len(json.dumps(manifest)) > 64 * 1024:
        bad.append("over 64 KiB")
    return bad
