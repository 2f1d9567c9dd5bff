"""Readings for the limits of a cell's comparison, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--variant fp8] [--faults half_batch,altered_grad]

runs, in one process, a short run of the cell for each seed with the
program as it is, then with ``--variant`` (the control, ``fp8``: the
reference with fp8 training's roundings in the program's place, judged by
the same checks), then each planted fault, and prints one JSON line a run
with every number read. The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from pbench import harness, manifest

    cell = manifest.Cell(ROOT, manifest.load(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = [(s, None, None) for s in seeds]
    if args.variant:
        plan += [(s, None, args.variant) for s in seeds]
    for fault in filter(None, args.faults.split(",")):
        plan += [(s, fault, None) for s in seeds[:3]]
    for seed, fault, variant in plan:
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               device=args.device, cell=cell, fault=fault,
                               variant=variant)
        row = {"seed": seed, "fault": fault, "variant": variant,
               "correct": out["correct"], "checks": {k: v["value"] for k, v in out["checks"].items()},
               "notes": out.get("notes"),
               "timing": out["timing"],
               "setup_s": out["metrics"].get("setup_s", {}).get("value"),
               "peak_gib": out["device"]["memory_peak_bytes"] / 2 ** 30,
               "run_s": time.perf_counter() - t0}
        print("CAL " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
