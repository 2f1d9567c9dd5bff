"""What the per-layer readers share: counts from the traced segment and
the frozen flop counts of a cell's work."""

from __future__ import annotations

from typing import Optional

from pbench import yardstick as ys


def _trace(ctx):
    return ctx.trace_obj if ctx.trace_obj is not None and ctx.device.type == "cuda" else None


def launches_per_unit(ctx) -> Optional[float]:
    tr = _trace(ctx)
    if tr is None or tr.kernel_count() == 0:
        return None
    return tr.kernel_count() / ctx.traced["units"]


def idle_percent(ctx) -> Optional[float]:
    tr = _trace(ctx)
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def train_pair_flops(ctx) -> float:
    im, tx = ctx.sizes["image"], ctx.sizes["text"]
    return ys.clip_pair_train_flops(
        ctx.traffic["size"], im["patch"], im["dim"], im["depth"],
        int(ctx.config["program"]["model"]["max_length"]), tx["dim"],
        tx["depth"], ctx.sizes["proj_dim"])
