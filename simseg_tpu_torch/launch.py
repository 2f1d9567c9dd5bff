"""Experiment launcher: one process per card (port of ``launch.py``).

    python -m simseg_tpu_torch.launch --task clip --nproc_per_node N \\
        --cfg configs/clip/simseg.vit-b.yaml --vocab_file vocab.txt [k=v ...]

Parity: reference ``launch.py:27-93``, which fans out N GPU processes
through ``torch.distributed.launch`` and tees the output to
``./output/<exp>_log.txt``. On a TPU the JAX launcher runs one process per
host, which drives all the host's chips; here each rank is a process of
its own on ``cuda:LOCAL_RANK``, running the task's entry point
(``tasks/clip/train.py``, or ``tasks/linear_prob/train.py`` for ``--task
linear_prob``) with the rest of the command line, which joins the world
through ``parallel/mesh.init_distributed``:

- it sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
  (``--master_addr``, default 127.0.0.1) and ``MASTER_PORT``
  (``--master_port``, default: one the OS picks as the launcher binds it),
  and serves the world's rendezvous store itself (torchrun's agent store,
  ``parallel/mesh.host_store``), so no other process can take the port
  before the ranks come up;
- it tees rank 0's output (stdout and stderr) to ``./output/<exp>_log.txt``
  (``<exp>``: ``--exp_name``, else the config's file name); the other ranks
  write to the launcher's own streams;
- it forwards SIGTERM to every rank (their ``PreemptionHook`` checkpoints
  one agreed step and exits 0) and ignores SIGINT, which a terminal already
  delivers to the whole foreground group;
- it exits with the first non-zero exit code of a rank, 128 + sig for a rank
  killed by a signal, after killing the ranks still running (they would
  wait for the lost rank at their next collective); 0 when all exit 0;
- it refuses ``--nproc_per_node`` larger than the number of cards, unless
  the ranks run on the CPU (``--device cpu``, gloo).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

TASKS = {"clip": "simseg_tpu_torch.tasks.clip.train",
         "linear_prob": "simseg_tpu_torch.tasks.linear_prob.train"}


def free_port() -> int:
    """A TCP port on the loopback that the OS reports free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_of(passthrough: Sequence[str]) -> Optional[str]:
    """The ``--device`` the ranks are given, or None (CUDA)."""
    for i, arg in enumerate(passthrough):
        if arg == "--device" and i + 1 < len(passthrough):
            return passthrough[i + 1]
        if arg.startswith("--device="):
            return arg.split("=", 1)[1]
    return None


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="SimSeg launcher (PyTorch port)")
    parser.add_argument("--task", type=str, default="clip",
                        choices=sorted(TASKS))
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--exp_name", type=str, default="")
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=0)
    return parser.parse_known_args(argv)


def _tee(stream, sinks) -> None:
    for line in iter(stream.readline, b""):
        for sink in sinks:
            sink.write(line)
            sink.flush()


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, passthrough = parse_args(argv)
    n = args.nproc_per_node
    if n < 1:
        raise SystemExit(f"launch: --nproc_per_node {n} must be at least 1")
    device = _device_of(passthrough)
    if device is None or not device.startswith("cpu"):
        import torch

        cards = torch.cuda.device_count()
        if n > cards:
            raise SystemExit(
                f"launch: --nproc_per_node {n} > the {cards} CUDA device(s) "
                "here: one rank per card (pass --device cpu for gloo ranks "
                "on the CPU)")

    exp = args.exp_name or os.path.splitext(os.path.basename(args.cfg))[0]
    os.makedirs("./output", exist_ok=True)
    log_path = f"./output/{exp}_log.txt"
    from simseg_tpu_torch.parallel.mesh import host_store

    store, store_env = host_store(args.master_addr, args.master_port)
    cmd = [sys.executable, "-m", TASKS[args.task], "--cfg", args.cfg, *passthrough]
    print(f"[launch] {n} rank(s): {' '.join(cmd)}", flush=True)
    print(f"[launch] teeing rank 0's output to {log_path}", flush=True)

    procs: List[subprocess.Popen] = []
    with open(log_path, "ab") as log:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), **store_env)
            out = subprocess.PIPE if r == 0 else None
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=subprocess.STDOUT if r == 0
                                          else None))
        tee = threading.Thread(target=_tee, args=(
            procs[0].stdout, (sys.stdout.buffer, log)), daemon=True)
        tee.start()

        def forward(signum, frame):
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signum)

        signal.signal(signal.SIGTERM, forward)
        signal.signal(signal.SIGINT, signal.SIG_IGN)

        rc = 0
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed and not rc:
                rc = failed[0]
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            if all(c is not None for c in codes):
                break
            time.sleep(0.05)
        tee.join(timeout=5)
    del store
    # a signal-killed rank has rc = -sig: report the conventional 128 + sig
    return 128 - rc if rc < 0 else rc


if __name__ == "__main__":
    sys.exit(main())
