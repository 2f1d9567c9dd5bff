"""Linear-probe training entry point (port of
``simseg_tpu/tasks/linear_prob/train.py``; parity: reference
``simseg/tasks/linear_prob/train.py:38-59``).

    python -m simseg_tpu_torch.tasks.linear_prob.train \\
        --cfg configs/linear_prob/imagenet.yaml data.data_path=DIR/ \\
        [ckpt.external_resume=simseg.vit-b.pth ckpt.only_load_image_encoder=true] \\
        [--device cpu] [a.b=value ...]

``main(argv)`` parses the arguments into a fresh config, joins the
``torch.distributed`` world a launcher describes (``python -m
simseg_tpu_torch.launch --task linear_prob``), builds the probe
(``models/linear_prob.py``, seeded from ``cfg.seed``), the class-folder
loaders of ``DIR/{train,val}`` (``build_imagenet_dataloaders``) and a
``LinearProbRunner`` on ``--device`` (default: CUDA, the rank's card),
runs it and returns the runner (its last validation in
``runner.state.linear_eval``). The YAML's global batch of 16,384 fits one
card as k runner steps of 16,384 / k through ``optim.grad_accum_steps:
k`` with ``data.batch_size`` 16,384 / k.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.core.runner import LinearProbRunner
from simseg_tpu_torch.data.datasets import build_imagenet_dataloaders
from simseg_tpu_torch.models.linear_prob import build_linear_prob_model
from simseg_tpu_torch.parallel.mesh import init_distributed
from simseg_tpu_torch.tasks.linear_prob.config import (task_cfg_init_fn,
                                                       update_linear_config)


def main(argv: Optional[Sequence[str]] = None) -> LinearProbRunner:
    parser = argparse.ArgumentParser(description="SimSeg linear probing")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, the rank's card)")
    args, overrides = parser.parse_known_args(argv)
    cfg = new_base_cfg()
    update_cfg(task_cfg_init_fn, args.cfg, overrides,
               preprocess_fn=update_linear_config, target=cfg)
    if cfg.runner.name != "linear_prob":
        raise NotImplementedError(f"runner '{cfg.runner.name}'")
    init_distributed(device=args.device)
    device = resolve_device(args.device)
    torch.manual_seed(int(cfg.seed or 0))
    model = build_linear_prob_model(cfg)
    loaders = build_imagenet_dataloaders(cfg)
    runner = LinearProbRunner(cfg, model, loaders, device=device)
    runner.run()
    return runner


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
