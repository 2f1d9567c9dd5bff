"""CLIP pretraining entry point (port of ``simseg_tpu/tasks/clip/train.py``).

    python -m simseg_tpu_torch.tasks.clip.train --cfg configs/clip/simseg.vit-b.yaml \
        --vocab_file vocab.txt data.data_path=DIR/ [--device cpu] [a.b=value ...]

    train(cfg, {"train": [loader]})              # on CUDA
    train(cfg, {"train": [loader]}, device="cpu")

``main(argv)`` parses the JAX entry point's arguments into a fresh config,
reads the WordPiece tokenizer from ``--vocab_file`` (required: the port has
no HuggingFace tokenizer), builds the CSV / parquet loaders
(``build_clip_dataloaders``) and trains with retrieval validation through
``train``, on ``--device`` (default: CUDA); it returns the runner.
``train`` builds the model from the config (seeded from ``cfg.seed``,
float32 parameters, bf16 compute under ``dist.bf16``) and a ``CLIPRunner``
over the given loaders, runs it and returns the runner. ``runner.name``
``clip`` trains the plain step, ``clip_bsgs`` BSGS (``engine/bsgs.py``:
the exact gradient of the ``data.batch_size`` batch, e.g. the vit-b YAML's
1024, in micro-batches of ``data.batch_size_train``); ``model.remat`` /
``model.remat_policy`` rematerialise the towers' blocks and
``optim.grad_accum_steps`` accumulates gradients over runner steps, as in
JAX.

Data parallelism: ``main`` joins the ``torch.distributed`` world that a
launcher describes in the environment (``parallel/mesh.init_distributed``:
NCCL on the cards, gloo under ``--device cpu``) before it builds the
loaders, which then shard by rank, and trains on the rank's card,
``cuda:LOCAL_RANK``. ``python -m simseg_tpu_torch.launch --task clip
--nproc_per_node N --cfg ...`` starts N such ranks.

The sharded legs (JAX :35-60): ``train`` builds the mesh from
``loss.group_size`` and ``dist.tp_size`` and hands it to
``build_clip_model`` (tensor parallelism, ``dist.sp``); the runner adds
``dist.fsdp`` and ``dist.zero1``. ``dist.tp_size`` must divide the world,
whose ranks then form model groups of that many ranks, each group one data
rank of the loaders.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional, Sequence

import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.config import cfg as global_cfg
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.data.datasets import build_clip_dataloaders
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.parallel.mesh import init_distributed, make_mesh
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config


def train(cfg, loaders: Dict[str, Sequence], tokenizer=None,
          device=None) -> CLIPRunner:
    """Train the CLIP model of ``cfg`` on ``loaders["train"]``; returns the
    runner (its ``model``, ``optimizer``, ``step`` and last ``outputs``)."""
    device = resolve_device(device)
    torch.manual_seed(int(cfg.seed or 0))
    mesh = make_mesh(int(cfg.loss.get("group_size", -1) or -1),
                     int(cfg.dist.get("tp_size", 1) or 1))
    model = build_clip_model(cfg, mesh)
    runner = CLIPRunner(cfg, model, loaders, device=device, tokenizer=tokenizer)
    runner.run()
    return runner


def parse_args(argv: Optional[Sequence[str]] = None, target=None):
    """``--cfg file.yaml [--vocab_file f] [--device d] [a.b=value ...]``
    into the config ``target`` (default: the package's global tree; JAX
    ``parse_args``, :24-32)."""
    parser = argparse.ArgumentParser(description="SimSeg CLIP pretraining")
    parser.add_argument("--cfg", type=str, required=True,
                        help="experiment configure file name")
    parser.add_argument("--vocab_file", type=str, default="",
                        help="WordPiece vocab.txt (required by main: the port "
                             "has no HuggingFace tokenizer)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, the rank's card)")
    args, overrides = parser.parse_known_args(argv)
    update_cfg(task_cfg_init_fn, args.cfg, overrides,
               preprocess_fn=update_clip_config,
               target=global_cfg if target is None else target)
    return args


def main(argv: Optional[Sequence[str]] = None) -> CLIPRunner:
    """Pretraining as the JAX entry point runs it (:35-60); returns the
    runner after its run."""
    cfg = new_base_cfg()
    args = parse_args(argv, target=cfg)
    if not args.vocab_file:
        raise SystemExit("train: --vocab_file is required (the port tokenizes "
                         "with WordPiece over a vocab.txt; it has no "
                         "HuggingFace tokenizer)")
    if cfg.runner.name not in ("clip", "clip_bsgs"):
        raise NotImplementedError(f"runner '{cfg.runner.name}'")
    init_distributed(device=args.device)
    device = resolve_device(args.device)
    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    loaders = build_clip_dataloaders(cfg, tokenizer=tokenizer)
    return train(cfg, loaders, tokenizer=tokenizer, device=device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
