"""Runs one cell of the benchmark of ``simseg_tpu_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights and inputs from the seed, the
program's kernels built or loaded, the cell's shapes warmed up) is timed
from the process's start; then the closed loop runs for ``--seconds``;
with ``--trace 1`` a traced segment follows. Then the program's state is
freed and the plain reference (``port_bench/pbench_ref``) recomputes what
the window produced. The last lines of standard error give each compared
number beside its limit; the last line of standard output is the result's
JSON object. It exits non-zero, with no result, without a CUDA card (or
with fewer than the cell asks for), if JAX or the JAX package is loaded,
and where the program is missing.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _env() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "port_bench", "_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "port_bench", "_cache", "torch_extensions")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch

    from pbench import harness, manifest

    cell = manifest.Cell(ROOT, manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t0=T0, cell=cell)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"no result: loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
