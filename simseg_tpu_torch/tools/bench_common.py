"""Shared timing and accounting for the port's attribution tools (port of
``tools/bench_common.py``).

``timed_secs`` times ``fn(*args)`` after one warm-up call: on a card with
CUDA events recorded on the current stream around ``iters`` calls (the
median of ``trials`` trials), on the CPU (``--device cpu``: PyTorch's CPU
kernels, no card's time) with the host clock. JAX's chained scalar
accumulator existed because a tunnel's ``block_until_ready`` could return
early; an event's time is the device's, so nothing is threaded through the
calls. Per-kernel times are not read from a profile: the profiler can miss
the cooperative CRF launches late in a process.

``tower_flops`` is JAX's analytic count. The peaks are the H100 SXM5 80 GB's
published dense figures (NVIDIA's data sheet, 700 W); on any other card the
tools print no MFU and no traffic floor, and say why.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Optional, Tuple

import torch

# NVIDIA H100 SXM5 80 GB, dense rates (no sparsity), at its 700-W limit
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"
H100_BF16_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    """``--device``: read with ``simseg_tpu_torch.resolve_device``, which
    refuses CUDA where there is no card."""
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA; the tool refuses to "
                         "run without a card unless given 'cpu')")


def card_line(device: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or a note
    that the numbers are the host's."""
    if device.type != "cuda":
        return "cpu, host clock"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(device: torch.device) -> Tuple[Optional[Tuple[float, float]], str]:
    """((bf16 FLOP/s, HBM bytes/s) or None, a line naming them or saying
    why there are none)."""
    if device.type != "cuda":
        return None, "no peak: a CPU run measures no card"
    name = torch.cuda.get_device_name(device)
    if name != H100_SXM_NAME:
        return None, (f"no peak for {name}: the tools know only the H100 SXM5 "
                      "80 GB's published figures")
    return ((H100_BF16_FLOP_PER_S, H100_HBM_BYTES_PER_S),
            f"peaks of the {name} (NVIDIA's data sheet, dense, at 700 W): "
            f"{H100_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16, "
            f"{H100_HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM3")


def print_card(device: torch.device) -> str:
    """Prints the card's line and its peaks; returns the card's line."""
    card = card_line(device)
    note = ("" if device.type == "cuda" else
            " (PyTorch's CPU kernels: no number below is a card's)")
    print(f"card: {card}{note}", flush=True)
    print(card_peaks(device)[1], flush=True)
    return card


def timed_secs(fn, args=(), iters: int = 20, trials: int = 3,
               device=None) -> float:
    """Median seconds per call of ``fn(*args)`` over ``trials`` trials of
    ``iters`` calls, after one warm-up call; CUDA events on a card (the
    default device), the host clock on the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    fn(*args)
    secs = []
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(trials):
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            secs.append(start.elapsed_time(end) / 1e3 / iters)
    else:
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            secs.append((time.perf_counter() - t0) / iters)
    return float(statistics.median(secs))


def timed_rate(fn, args, batch: int, iters: int = 20, trials: int = 3,
               device=None) -> float:
    """Median items/second for a per-call batch of ``batch``."""
    return batch / timed_secs(fn, args, iters=iters, trials=trials,
                              device=device)


def tower_flops(t: int, d: int, depth: int, extra: float = 0.0) -> float:
    """Analytic transformer-tower forward flops: per block 4*T*D^2 MACs
    (qkv + proj) + 2*T^2*D (scores + context) + 8*T*D^2 (mlp); ``extra``
    adds patch-embed / projection MACs. Returns flops (2 per MAC)."""
    per_block = 12 * t * d * d + 2 * t * t * d
    return 2.0 * (depth * per_block + extra)


def flagship_flops() -> Tuple[float, float]:
    """(ViT-B/16 at 288 px, BERT-base at 25 tokens) forward flops a sample,
    with the patch embedding and the 512-d projections (JAX's MFU lines)."""
    vit = tower_flops(325, 768, 12, extra=325 * 768 * (3 * 256) + 325 * 768 * 512)
    bert = tower_flops(25, 768, 12, extra=25 * 768 * 512)
    return vit, bert


def launch_counts() -> dict:
    """Kernel name -> its wrapper's launch count (the counters
    ``chip_smoke.py`` reads)."""
    from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention

    return {"crf_mean_field": crf_fused.LAUNCHES,
            "seg_decode_tail": crf_fused.TAIL_LAUNCHES,
            "crf_mean_field_bf16": crf_fused.BF16_LAUNCHES,
            "seg_decode_tail_bf16": crf_fused.BF16_TAIL_LAUNCHES,
            "bilateral_matvec": crf_pallas.LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES,
            "flash_attention_bwd": flash_attention.BWD_LAUNCHES}


def launches_of(fn, *args) -> dict:
    """The kernel launches of one call of ``fn(*args)`` (nonzero only)."""
    before = launch_counts()
    fn(*args)
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}
