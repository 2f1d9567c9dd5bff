"""Zero-shot image-text retrieval evaluation CLI (port of
``tools/retrieval_evaluation.py``).

Parity: reference ``tools/retrieval_evaluation.py:102-157`` — the same
flags (``--cfg``, ``--ckpt_path``, ``--vocab_file``, dotted config
overrides) and flow: config -> model -> checkpoint -> per
``data.valid_name``: the ``valid.parquet`` loader, the embeddings batch by
batch, R@1/5/10 and RSUM. ``--device`` picks the device (default: CUDA);
``--vocab_file`` (a WordPiece ``vocab.txt``) is required, since the port
has no HuggingFace tokenizer. Reading parquet needs pyarrow.

In a ``torch.distributed`` world (one process per card, started by a
launcher that sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, such as ``torchrun``) each rank
embeds its shard of the set; rank 0 calibrates an int8 tower and every
rank takes its calibration (JAX ``tools/retrieval_evaluation.py:46-71``),
and the embeddings and ids are gathered from every rank, the shorter
shards padded with id -1 rows that are dropped after, an empty shard
joining the gather with no rows (JAX ``:105-146``), so every rank reports
the whole set's table.

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
from simseg_tpu_torch.ops.quant import broadcast_quant_state, cache_quant_state
from simseg_tpu_torch.parallel.collectives import allgather_rows
from simseg_tpu_torch.parallel.mesh import init_distributed, is_distributed, rank
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
    (its images as the loader gives them, unnormalised); in a world, rank
    0's loader, and every rank takes its state. In a world the table is
    that of every rank's shard together."""
    device = resolve_device(device)
    model = model.to(device).eval()
    mean = tuple(cfg.transforms.normalize.mean)
    std = tuple(cfg.transforms.normalize.std)
    img_q, txt_q = model.image_tower.quant or "none", model.bert.quant or "none"
    if (img_q != "none" or txt_q != "none") and rank() == 0:
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
    broadcast_quant_state(model)

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
    if not imgs:
        # an empty shard still joins the gather, with no rows
        dim = int(cfg.model.projection.dim)
        imgs = txts = [torch.zeros((0, dim), device=device)]
        iids = cids = [torch.zeros((0,), dtype=torch.int64)]
    img, txt = torch.cat(imgs), torch.cat(txts)
    iid, cid = torch.cat(iids).numpy(), torch.cat(cids).numpy()
    if is_distributed():
        img, txt, iid, cid = allgather_rows(
            [img.cpu().numpy(), txt.cpu().numpy(), iid, cid], [0.0, 0.0, -1, -1])
        keep = iid >= 0
        img = torch.from_numpy(img[keep]).to(device)
        txt = torch.from_numpy(txt[keep]).to(device)
        iid, cid = iid[keep], cid[keep]
    summary = retrieval_summary(img, txt, iid, cid)
    logger.info(" ".join(f"{k}: {v:.4f}" for k, v in summary.items()))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Runs the evaluation; returns {dataset: its retrieval table}."""
    args, cfg = parse_args(argv)
    if not args.vocab_file:
        raise SystemExit("retrieval_evaluation: --vocab_file is required (the "
                         "port tokenizes with WordPiece over a vocab.txt; it "
                         "has no HuggingFace tokenizer)")
    init_distributed(device=args.device)
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
