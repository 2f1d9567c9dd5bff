"""Zero-shot image-text retrieval evaluation CLI (port of
``tools/retrieval_evaluation.py``).

Parity: reference ``tools/retrieval_evaluation.py:102-157`` — the same
flags (``--cfg``, ``--ckpt_path``, ``--vocab_file``, dotted config
overrides) and flow: config -> model -> checkpoint -> per
``data.valid_name``: the ``valid.parquet`` loader, the embeddings batch by
batch, R@1/5/10 and RSUM. ``--device`` picks the device (default: CUDA);
``--vocab_file`` (a WordPiece ``vocab.txt``) is required, since the port
has no HuggingFace tokenizer. Reading parquet needs pyarrow. The gather
across processes is not ported (ROADMAP queue 1 item 13).

Usage:
    python -m simseg_tpu_torch.tools.retrieval_evaluation \\
        --cfg configs/clip/simseg.vit-b.yaml --ckpt_path simseg.vit-b.pth \\
        --vocab_file vocab.txt data.valid_name=[f30k] data.data_path=DIR/
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Iterable, Optional, Sequence

import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.checkpoint import load_pretrained_params
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.datasets import (DataLoader, ParquetRetrievalDataset,
                                            process_shard)
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
from simseg_tpu_torch.data.transforms import build_transforms, normalize_images
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.ops.quant import cache_quant_state
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config
from simseg_tpu_torch.utils.retrieval import retrieval_summary

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None):
    """(args, config tree) from ``argv``: the flags, then the YAML and the
    dotted overrides merged into a fresh tree."""
    parser = argparse.ArgumentParser(
        description="SimSeg retrieval evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--vocab_file", type=str, default="",
                        help="WordPiece vocab.txt (required: the port has "
                             "no HuggingFace tokenizer)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA)")
    args, overrides = parser.parse_known_args(argv)
    cfg = update_cfg(task_cfg_init_fn, args.cfg, overrides,
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    return args, cfg


def evaluate_benchmark(loader: Iterable[dict], model, cfg,
                       device=None) -> Dict[str, float]:
    """The retrieval table of one loader (parity: reference :65-99): each
    batch's uint8 images normalised on ``device`` (None: CUDA) and embedded
    in float32 with the caption ids, then ``retrieval_summary``. A tower
    whose ``arch.quant`` is int8 or int8_static first caches its int8
    weights and calibrates on the loader's first batch, as JAX's CLI does
    (its images as the loader gives them, unnormalised)."""
    device = resolve_device(device)
    model = model.to(device).eval()
    mean = tuple(cfg.transforms.normalize.mean)
    std = tuple(cfg.transforms.normalize.std)
    img_q, txt_q = model.vit.quant or "none", model.bert.quant or "none"
    if img_q != "none" or txt_q != "none":
        first = next(iter(loader))
        calls = []
        if img_q != "none":
            images = torch.as_tensor(first["image"]).to(device).float()
            calls.append(lambda: model.forward_image_tokens(images))
        if txt_q != "none":
            ids = torch.as_tensor(first["input_ids"]).to(device).long()
            mask = torch.as_tensor(first["attention_mask"]).to(device).long()
            calls.append(lambda: model.forward_text_feature(ids, mask))
        cache_quant_state(model, calls)

    imgs, txts, iids, cids = [], [], [], []
    with torch.no_grad():
        for batch in loader:
            images = torch.as_tensor(batch["image"]).to(device)
            if images.dtype == torch.uint8:
                images = normalize_images(images, mean, std)
            img, txt, _ = model(
                {"image": images,
                 "input_ids": torch.as_tensor(batch["input_ids"]).to(device).long(),
                 "attention_mask": torch.as_tensor(
                     batch["attention_mask"]).to(device).long()},
                deterministic=True)
            imgs.append(img.float())
            txts.append(txt.float())
            iids.append(torch.as_tensor(batch["image_id"]))
            cids.append(torch.as_tensor(batch["caption_id"]))
    summary = retrieval_summary(torch.cat(imgs), torch.cat(txts),
                                torch.cat(iids).numpy(), torch.cat(cids).numpy())
    logger.info(" ".join(f"{k}: {v:.4f}" for k, v in summary.items()))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Runs the evaluation; returns {dataset: its retrieval table}."""
    args, cfg = parse_args(argv)
    if not args.vocab_file:
        raise SystemExit("retrieval_evaluation: --vocab_file is required (the "
                         "port tokenizes with WordPiece over a vocab.txt; it "
                         "has no HuggingFace tokenizer)")
    device = resolve_device(args.device)
    model = build_clip_model(cfg)
    if args.ckpt_path:
        load_pretrained_params(args.ckpt_path, model)
        logger.info("Loaded ckpt path: %s", args.ckpt_path)
    else:
        logger.warning("No --ckpt_path: evaluating randomly initialised weights")
    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    shard, nshards = process_shard()
    tf = build_transforms(cfg, "valid")
    results = {}
    for name in cfg.data.valid_name:
        logger.info("Evaluating retrieval on %s", name)
        loader = DataLoader(ParquetRetrievalDataset(cfg, name, tokenizer, tf),
                            cfg.data.batch_size_val,
                            num_workers=cfg.data.num_workers,
                            shard_index=shard, shard_count=nshards)
        results[name] = evaluate_benchmark(loader, model, cfg, device=device)
        print(f"{name}: " + " ".join(f"{k}: {v:.4f}"
                                      for k, v in results[name].items()))
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
