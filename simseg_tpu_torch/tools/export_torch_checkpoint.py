"""Export a trained model as a reference-layout torch ``.pth`` checkpoint
(port of ``tools/export_torch_checkpoint.py``).

The reverse of the loading bridge: a checkpoint trained with the port (its
msgpack directory or ``ckpt.dir``, an orbax-backend directory of step
directories, or a ``.pth`` being round-tripped) is written in the PyTorch
reference's state-dict layout (``checkpoint/torch_export.py``), so the
original SimSeg codebase and its eval tools load it with ``strict=True``.
The same flags as JAX's tool and dotted overrides; ``--device`` picks
where the model is built and loaded (default: CUDA).

Usage:
    python -m simseg_tpu_torch.tools.export_torch_checkpoint \\
        --cfg configs/clip/simseg.vit-b.yaml --ckpt_path output/run/ckpt \\
        --out simseg_vitb.pth
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.checkpoint import load_pretrained_params
from simseg_tpu_torch.checkpoint.torch_export import save_clip_checkpoint
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Writes ``--out``; returns the export's report (exported keys,
    skipped paths)."""
    ap = argparse.ArgumentParser(
        description="export a reference-layout .pth (PyTorch port)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--ckpt_path", required=True,
                    help="the port's checkpoint dir / ckpt.dir parent / "
                         "orbax-backend dir, or a torch .pth to round-trip")
    ap.add_argument("--out", required=True)
    ap.add_argument("--non_strict", action="store_true",
                    help="tolerate (with a warning) a partial .pth source "
                         "checkpoint and leaves the reference layout has no "
                         "slot for, instead of raising")
    ap.add_argument("--device", default=None,
                    help="torch device the model is built on (default: CUDA)")
    args, overrides = ap.parse_known_args(argv)
    cfg = update_cfg(task_cfg_init_fn, args.cfg, overrides,
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    model = build_clip_model(cfg).to(resolve_device(args.device))
    # strict by default: a missing or mismatched source key would otherwise
    # keep the random initialisation and export it as if trained
    load_pretrained_params(args.ckpt_path, model, strict=not args.non_strict)
    report = save_clip_checkpoint(
        args.out, model,
        meta={"source": args.ckpt_path, "cfg": args.cfg,
              "exporter": "simseg_tpu_torch"},
        strict=not args.non_strict)
    print(f"wrote {args.out}: {len(report['exported'])} tensors"
          + (f", {len(report['skipped'])} skipped" if report["skipped"] else ""))
    return report


if __name__ == "__main__":
    main()
