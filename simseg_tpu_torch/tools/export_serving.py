"""Export a serving artifact through ``torch.export`` (port of
``tools/export_serving.py``).

The same flags and flow: config -> model -> checkpoint (``.pth`` through
the bridge, or the port's own checkpoint directory) -> int8 calibration
(``--calib_npy`` or random images) -> for ``--kind seg`` the dataset's
prompt-ensembled class-text bank (``top_cls_num`` 30 for pascal_context,
else 10) -> the staged pipeline of ``simseg_tpu_torch/serving.py``,
written to ``--out`` (``--weights separate``: the weights to
``<out>.weights``). ``--device`` picks the device the artifact is traced on
and serves on (default: CUDA); JAX's ``--platforms`` is refused, since a
``torch.export`` artifact is traced on the device it runs on.

Usage:
    python -m simseg_tpu_torch.tools.export_serving \\
        --cfg configs/clip/simseg.vit-b.yaml --ckpt_path simseg.vit-b.pth \\
        --vocab_file vocab.txt --kind seg --dataset pascal_voc --batch 64 \\
        --out simseg_vitb_voc_b64.pt2

    --kind seg        the zero-shot segmentation pipeline
    --kind retrieval  the two-tower embedding forward
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from simseg_tpu_torch import resolve_device, serving
from simseg_tpu_torch.checkpoint import load_pretrained_params
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.ops.quant import cache_quant_state
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None):
    """(args, config tree) from ``argv``: the flags, then the YAML and the
    dotted overrides merged into a fresh tree."""
    ap = argparse.ArgumentParser(
        description="SimSeg serving export (PyTorch port)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--ckpt_path", default="")
    ap.add_argument("--kind", choices=("seg", "retrieval"), default="seg")
    ap.add_argument("--dataset", default="pascal_voc")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab_file", default="",
                    help="WordPiece vocab.txt (required for --kind seg: the "
                         "port has no HuggingFace tokenizer)")
    ap.add_argument("--device", default=None,
                    help="torch device the artifact is traced on and serves "
                         "on (default: CUDA)")
    ap.add_argument("--platforms", default="",
                    help="refused: the port exports for the device it runs on")
    ap.add_argument("--calib_images", type=int, default=32,
                    help="int8: number of calibration images when "
                         "--calib_npy is not given (random data; use real "
                         "images for production)")
    ap.add_argument("--calib_npy", default="",
                    help="int8: .npy of (N, size, size, 3) float32 "
                         "normalised images for the activation calibration")
    ap.add_argument("--weights", choices=("baked", "separate"),
                    default="baked",
                    help="'baked': the weights inside the artifact; "
                         "'separate': the weights as graph inputs, written "
                         "to <out>.weights (small graph, weight rotation "
                         "without re-export)")
    args, overrides = ap.parse_known_args(argv)
    cfg = update_cfg(task_cfg_init_fn, args.cfg, overrides,
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    return args, cfg


def calibrate(model, args, size: int, max_length: int, device) -> None:
    """Cache the int8 towers' weights and calibrate their activation scales
    (JAX ``tools/export_serving.py:82-114``) on ``--calib_npy`` or on
    random images, in chunks of 8, and for a quantised text tower on random
    ids; nothing for float towers."""
    if (model.image_tower.quant or "none") == "none" and (
            model.bert.quant or "none") == "none":
        return
    rng = np.random.default_rng(0)
    if args.calib_npy:
        imgs = np.load(args.calib_npy).astype(np.float32)
    else:
        logger.warning("calibrating int8 activation scales on random data; "
                       "pass --calib_npy with representative images for "
                       "production exports")
        imgs = rng.normal(size=(args.calib_images, size, size, 3)
                          ).astype(np.float32)
    calls = [lambda im=torch.from_numpy(imgs[i:i + 8]).to(device):
             model.forward_image_tokens(im) for i in range(0, len(imgs), 8)]
    if (model.bert.quant or "none") != "none":
        ids = torch.from_numpy(rng.integers(0, 100, (8, max_length))).to(device)
        calls.append(lambda: model.forward_text_feature(ids,
                                                        torch.ones_like(ids)))
    cache_quant_state(model, calls)
    print(f"calibrated int8 quant state on {len(imgs)} images")


def main(argv: Optional[Sequence[str]] = None) -> torch.nn.Module:
    """Writes the artifact; returns the staged module it was traced from
    (``serving.make_seg_infer_fn`` / ``make_embed_fn``), live."""
    args, cfg = parse_args(argv)
    if args.platforms:
        raise SystemExit("export_serving: --platforms is not taken: the port "
                         "exports for the device it runs on (--device)")
    if args.kind == "seg" and not args.vocab_file:
        raise SystemExit("export_serving: --vocab_file is required for --kind "
                         "seg (the port tokenizes with WordPiece over a "
                         "vocab.txt; it has no HuggingFace tokenizer)")
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = build_clip_model(cfg)
    if args.ckpt_path:
        load_pretrained_params(args.ckpt_path, model)
    else:
        print("WARNING: no --ckpt_path, exporting randomly initialised weights")
    model = model.to(device).eval()
    size = cfg.transforms.input_size
    max_length = cfg.model.max_length
    calibrate(model, args, size, max_length, device)
    baked = args.weights == "baked"
    images = torch.zeros((args.batch, size, size, 3), dtype=torch.uint8,
                         device=device)
    if args.kind == "seg":
        from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
        from simseg_tpu_torch.tasks.seg_eval import (image_patch_stride,
                                                     load_label_bank,
                                                     zero_shot_classifier)

        tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
        classes = load_label_bank(args.dataset)
        bank = zero_shot_classifier(model, classes, tokenizer, max_length,
                                    device=device)
        fn = serving.make_seg_infer_fn(
            model, bank, cfg, num_classes=len(classes),
            top_cls_num=30 if args.dataset == "pascal_context" else 10,
            patch_size=image_patch_stride(model), bake_weights=baked,
            device=device)
        example = (images,)
    else:
        fn = serving.make_embed_fn(model, cfg, bake_weights=baked,
                                   device=device)
        example = (images,
                   torch.zeros((args.batch, max_length), dtype=torch.long,
                               device=device),
                   torch.ones((args.batch, max_length), dtype=torch.long,
                              device=device))
    if baked:
        data = serving.export_artifact(fn, example)
        serving.save_artifact(args.out, data)
        size_mb = len(data) / 1e6
    else:
        serving.export_artifact_separate(fn, fn.params, example, args.out)
        size_mb = os.path.getsize(args.out) / 1e6
        print(f"wrote {args.out}.weights "
              f"({os.path.getsize(args.out + '.weights') / 1e6:.1f} MB)")
    print(f"wrote {args.out} ({size_mb:.1f} MB, kind={args.kind}, "
          f"weights={args.weights}, batch={args.batch}, input={size}px, "
          f"device={device})")
    return fn


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
