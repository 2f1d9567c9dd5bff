"""CLIP pretraining entry point (port of ``simseg_tpu/tasks/clip/train.py``).

    train(cfg, {"train": [loader]})              # on CUDA
    train(cfg, {"train": [loader]}, device="cpu")

``train`` builds the model from the config (seeded from ``cfg.seed``,
float32 parameters, bf16 compute under ``dist.bf16``) and a ``CLIPRunner``
over the given loaders, runs it and returns the runner. ``main()`` parses
the JAX entry point's arguments into the config; the dataset loader that it
would then build (``build_clip_dataloaders``) is not ported yet (ROADMAP
queue 1 item 10), so it stops there rather than make up data.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.config import cfg as global_cfg
from simseg_tpu_torch.config import update_cfg
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config


def train(cfg, loaders: Dict[str, Sequence], tokenizer=None,
          device=None) -> CLIPRunner:
    """Train the CLIP model of ``cfg`` on ``loaders["train"]``; returns the
    runner (its ``model``, ``optimizer``, ``step`` and last ``outputs``)."""
    device = resolve_device(device)
    torch.manual_seed(int(cfg.seed or 0))
    model = build_clip_model(cfg)
    runner = CLIPRunner(cfg, model, loaders, device=device, tokenizer=tokenizer)
    runner.run()
    return runner


def parse_args(argv: Optional[Sequence[str]] = None, target=None):
    """``--cfg file.yaml [--vocab_file f] [a.b=value ...]`` into the config
    (JAX ``parse_args``, :24-32)."""
    parser = argparse.ArgumentParser(description="SimSeg CLIP pretraining")
    parser.add_argument("--cfg", type=str, required=True,
                        help="experiment configure file name")
    parser.add_argument("--vocab_file", type=str, default="")
    args, overrides = parser.parse_known_args(argv)
    update_cfg(task_cfg_init_fn, args.cfg, overrides,
               preprocess_fn=update_clip_config,
               target=global_cfg if target is None else target)
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    parse_args(argv)
    raise NotImplementedError(
        "the CLIP pair dataset loader (build_clip_dataloaders) is not ported "
        "yet (ROADMAP queue 1 item 10); call "
        "simseg_tpu_torch.tasks.clip.train.train(cfg, {'train': [loader]}) "
        "with your own batches")


if __name__ == "__main__":
    main()
