"""Zero-shot semantic segmentation evaluation CLI (port of
``tools/seg_evaluation.py``).

Parity: reference ``tools/seg_evaluation.py:184-253`` — the same flags
(``--cfg``, ``--ckpt_path``, ``--vocab_file``, dotted config overrides),
the same flow: config -> model -> checkpoint (``pos_embed`` resampled to
the model's grid) -> tokenizer -> per ``data.valid_name``: the loader, the
label bank, ``top_cls_num`` (30 for pascal_context, else 10) and
``evaluate_benchmark`` with the ``seg_eval`` and ``transforms`` knobs.
``--device`` picks the device (default: CUDA). The tokenizer is JAX's
``build_tokenizer``: a HuggingFace tokenizer of the tag where one resolves
offline, else WordPiece over ``--vocab_file``. In a ``torch.distributed`` world (one process per card, its
rank environment set by a launcher such as ``torchrun``) each rank
evaluates its shard of each set and every rank reports the whole set's
mIoU (``tasks/seg_eval.evaluate_benchmark``).

Usage:
    python -m simseg_tpu_torch.tools.seg_evaluation \\
        --cfg configs/clip/simseg.vit-b.yaml --ckpt_path simseg.vit-b.pth \\
        --vocab_file vocab.txt data.valid_name=[pascal_voc]
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.checkpoint import load_pretrained_params
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.datasets import build_seg_valid_loader
from simseg_tpu_torch.data.tokenizer import build_tokenizer
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.parallel.mesh import init_distributed
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config
from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark, load_label_bank

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None):
    """(args, config tree) from ``argv``: the flags, then the YAML and the
    dotted overrides merged into a fresh tree."""
    parser = argparse.ArgumentParser(
        description="SimSeg zero-shot segmentation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--vocab_file", type=str, default="",
                        help="WordPiece vocab.txt, taken where no HuggingFace "
                             "tokenizer of the tag resolves offline")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA)")
    args, overrides = parser.parse_known_args(argv)
    cfg = update_cfg(task_cfg_init_fn, args.cfg, overrides,
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    return args, cfg


def main(argv: Optional[Sequence[str]] = None
         ) -> Dict[str, Tuple[np.ndarray, float]]:
    """Runs the evaluation; returns {dataset: (per-class IoU, mIoU)}."""
    args, cfg = parse_args(argv)
    init_distributed(device=args.device)
    device = resolve_device(args.device)
    model = build_clip_model(cfg)
    if args.ckpt_path:
        load_pretrained_params(args.ckpt_path, model)
        logger.info("Loaded ckpt path: %s", args.ckpt_path)
    else:
        logger.warning("No --ckpt_path: evaluating randomly initialised weights")
    tokenizer = build_tokenizer(cfg.model.text_encoder.tag,
                                vocab_file=args.vocab_file or None)
    seg = cfg.seg_eval
    results = {}
    for name in cfg.data.valid_name:
        loader = build_seg_valid_loader(cfg, name, device=device)
        categories = load_label_bank(name)
        top_cls_num = 30 if name == "pascal_context" else 10
        results[name] = evaluate_benchmark(
            loader, model, tokenizer, categories, top_cls_num, name,
            input_size=cfg.transforms.input_size,
            mean=tuple(cfg.transforms.normalize.mean),
            std=tuple(cfg.transforms.normalize.std),
            bilateral_stride=seg.bilateral_stride,
            max_length=cfg.model.max_length, scales=tuple(seg.scales),
            window_size=int(seg.window.size),
            window_stride=int(seg.window.stride),
            crf_backend=seg.crf_backend, compute_dtype=seg.crf_dtype,
            device=device)
        iou, miou = results[name]
        print(f"{name}: multi class iou: {np.round(iou, 4)}")
        print(f"{name}: final mean iou: {miou:.4f}")
    return results


if __name__ == "__main__":
    main()
