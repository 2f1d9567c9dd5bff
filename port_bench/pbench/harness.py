"""One run of one cell: set-up, the measured window, the traced segment,
the readers, the comparison with the reference, and the result's line.

A kind (``port_bench/kinds/<name>.py``, named by the traffic) owns what
differs between kinds of work. It has ``setup(ctx)``, ``window(ctx)``
(the measured closed loop, filling ``ctx.window``), ``traced(ctx, units)``
(the same loop over ``units`` calls under the profiler, filling
``ctx.traced``), ``release(ctx)`` (the program's state freed) and
``judge(ctx)`` (the reference, returning the numbers compared).
"""

from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from pbench import manifest as mf
from pbench.trace import Trace

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "simseg_tpu")
# seconds of device work a traced segment aims at
TRACE_SECONDS = 2.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``simseg_tpu_torch`` is not
    ``simseg_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(mf.HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pb_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Ctx:
    """What a run knows, handed to the kind and the readers."""

    def __init__(self, cell: mf.Cell, seed: int, seconds: float, trace: bool,
                 device: str, fault: Optional[str] = None,
                 variant: Optional[str] = None, say: Callable = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.sizes = cell.config["sizes"]
        self.device = torch.device(device)
        self.fault, self.variant = fault, variant
        self.window: Dict = {}
        self.traced: Dict = {}
        self.trace_obj: Optional[Trace] = None
        self.state: Dict = {}
        self.say = say or (lambda msg: print(msg, file=sys.stderr, flush=True))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def profile_units(ctx: Ctx, body: Callable[[int], None], units: int) -> None:
    """``body(i)`` for i < units under the profiler; fills ``ctx.traced``
    (units) and ``ctx.trace_obj``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ctx.sync()
    with profile(activities=acts) as prof:
        for i in range(units):
            body(i)
        ctx.sync()
    ctx.trace_obj = Trace(prof)
    ctx.traced["units"] = units


def traced_units(ctx: Ctx) -> int:
    """Calls in the traced segment: about ``TRACE_SECONDS`` of the window's
    pace, at least 3."""
    per = ctx.window["seconds"] / max(1, ctx.window["units"])
    return max(3, min(ctx.window["units"], int(round(TRACE_SECONDS / per))))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             fault: Optional[str] = None, variant: Optional[str] = None,
             cell: Optional[mf.Cell] = None) -> dict:
    """One run; returns the result's object (``checks`` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or mf.Cell(root, mf.load(root), workload)
    ctx = Ctx(cell, seed, seconds, trace, device, fault, variant)
    kind = load_module("kinds", cell.traffic["kind"])
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    kind.setup(ctx)
    ctx.sync()
    ctx.window["setup_s"] = time.perf_counter() - t0
    kind.window(ctx)
    if trace:
        kind.traced(ctx, traced_units(ctx))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded: {loaded}")
    kind.release(ctx)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = kind.judge(ctx)
    t_ref = time.perf_counter() - t_ref
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is None:
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(ctx.window["units"]),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and ctx.trace_obj is not None:
        dev["busy_s"] = ctx.trace_obj.busy_s
        dev["window_s"] = ctx.trace_obj.window_s
        out["breakdown"] = {"device_ops": ctx.trace_obj.top_ops(),
                            "idle_gaps": ctx.trace_obj.idle_gaps()}
    if "notes" in ctx.state:
        out["notes"] = ctx.state["notes"]
    out["timing"] = {"window_s": ctx.window["seconds"], "reference_s": t_ref}
    out["checks"] = checks
    return out
