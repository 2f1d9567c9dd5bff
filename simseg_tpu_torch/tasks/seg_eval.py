"""Zero-shot semantic segmentation evaluation (port of
``simseg_tpu/tasks/seg_eval.py``, single-scale).

Parity: reference ``tools/seg_evaluation.py`` —
- zero_shot_classifier (:57-75): per class, embed the 80 OpenAI prompts
  through the text tower, mean, L2-normalise
- evaluate_benchmark (:78-181): per batch, towers + decode + GT-size nearest
  resize + mIoU accumulation

The options the JAX version reads from its config tree are keywords here
(``input_size``, ``mean``, ``std``, ``bilateral_stride``, ``max_length``,
``top_cls_num``). Multi-scale and sliding-window inference, int8 towers and
multi-process sharding are not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize_images
from simseg_tpu_torch.ops.morphology import resize_nearest_to_padded
from simseg_tpu_torch.ops.pooling import l2_normalize
from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
from simseg_tpu_torch.utils.metrics import intersect_and_union, miou_from_totals
from simseg_tpu_torch.utils.prompts import openai_imagenet_template

logger = logging.getLogger(__name__)

# per-dataset GT canvas (pixels); labels are padded with 255 (ignored)
GT_CANVAS = {"pascal_voc": 512, "pascal_context": 512, "coco_stuff": 640}

_LABEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "label_category")


def load_label_bank(name: str) -> list:
    """Class names of a packaged label bank (``data/label_category``)."""
    with open(os.path.join(_LABEL_DIR, f"{name}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


@torch.no_grad()
def zero_shot_classifier(model, classnames: Sequence[str], tokenizer,
                         max_length: int = 25, device=None) -> torch.Tensor:
    """(C, D) float32 L2-normalised class embeddings on ``device``."""
    device = resolve_device(device)
    out = []
    for cls in classnames:
        enc = tokenizer(openai_imagenet_template(cls), padding="max_length",
                        truncation=True, max_length=max_length)
        ids = torch.tensor(enc["input_ids"], dtype=torch.long, device=device)
        mask = torch.tensor(enc["attention_mask"], dtype=torch.long,
                            device=device)
        emb = model.forward_text_project(
            model.forward_text_feature(ids, mask), mask).float()
        mean = emb.mean(dim=0)
        out.append(mean / torch.linalg.vector_norm(mean))
    return torch.stack(out)


def make_seg_predict(model, num_classes: int, top_cls_num: int, *,
                     input_size: int, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD,
                     bilateral_stride: int = 8,
                     patch_size: Optional[int] = None, device=None):
    """``predict(images_u8, text_bank) -> (pred, best_w)`` on ``device``
    (the model must be there): normalisation, towers and decode,
    single-scale."""
    device = resolve_device(device)
    patch_size = patch_size or model.patch_size
    decode = make_seg_decode_fn(
        num_classes=num_classes, image_size=input_size, patch_size=patch_size,
        top_cls_num=top_cls_num, candidate_classes=5,
        bilateral_stride=bilateral_stride)

    @torch.no_grad()
    def predict(images_u8: torch.Tensor, text_bank: torch.Tensor):
        images_u8, text_bank = images_u8.to(device), text_bank.to(device)
        images = normalize_images(images_u8, mean, std)
        patches = model.forward_image_tokens(images)[:, 1:]
        pooled = model.forward_image_project(patches).float()
        dense = l2_normalize(model.project_image_tokens(patches).float())
        return decode(dense, pooled, text_bank, images_u8)

    return predict


def make_seg_forward(model, num_classes: int, top_cls_num: int, canvas: int, *,
                     input_size: int, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD,
                     bilateral_stride: int = 8,
                     patch_size: Optional[int] = None,
                     return_pred: bool = False, device=None):
    """``forward(images_u8, text_bank, labels_padded, gt_h, gt_w) ->
    (intersection, union[, resized preds])`` on ``device``:
    ``make_seg_predict`` plus the per-image nearest resize to the GT size
    inside the (canvas, canvas) label canvas and the confusion histograms."""
    device = resolve_device(device)
    predict = make_seg_predict(model, num_classes, top_cls_num,
                               input_size=input_size, mean=mean, std=std,
                               bilateral_stride=bilateral_stride,
                               patch_size=patch_size, device=device)

    @torch.no_grad()
    def forward(images_u8, text_bank, labels_padded, gt_h, gt_w):
        pred, _ = predict(images_u8, text_bank)
        labels_padded, gt_h, gt_w = (t.to(device) for t in
                                     (labels_padded, gt_h, gt_w))
        total_i = torch.zeros(num_classes, device=pred.device)
        total_u = torch.zeros(num_classes, device=pred.device)
        resized = []
        for i in range(pred.shape[0]):
            r = resize_nearest_to_padded(pred[i], gt_h[i], gt_w[i], canvas,
                                         canvas, fill=0)
            inter, union, _, _ = intersect_and_union(r, labels_padded[i],
                                                     num_classes, 255)
            total_i += inter
            total_u += union
            resized.append(r)
        if return_pred:
            return total_i, total_u, torch.stack(resized)
        return total_i, total_u

    return forward


def evaluate_benchmark(loader: Iterable[dict], model, tokenizer,
                       seg_categories: Sequence[str], top_cls_num: int,
                       dataset_name: str, *, input_size: int,
                       mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD,
                       bilateral_stride: int = 8, max_length: int = 25,
                       device=None) -> Tuple[np.ndarray, float]:
    """Dataset mIoU. Returns (per-class IoU, mIoU). Moves ``model`` to
    ``device`` and into eval mode.

    loader: any iterable of batch dicts with ``image`` uint8 (B, S, S, 3),
    ``mask_label`` (B, H, W) 255-padded, and optionally ``mask_h`` /
    ``mask_w``. When it has a ``batch_size``, a ragged last batch is padded
    to it with all-255 labels, as the JAX version pads to its compiled shape.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    num_classes = len(seg_categories)
    canvas = GT_CANVAS.get(dataset_name, 640)
    logger.info("Building zero-shot classifier for %d classes", num_classes)
    text_bank = zero_shot_classifier(model, seg_categories, tokenizer,
                                     max_length=max_length, device=device)
    forward = make_seg_forward(model, num_classes, top_cls_num, canvas,
                               input_size=input_size, mean=mean, std=std,
                               bilateral_stride=bilateral_stride,
                               device=device)

    full_batch = getattr(loader, "batch_size", None)
    total_i = np.zeros((num_classes,), np.float64)
    total_u = np.zeros((num_classes,), np.float64)
    count = 0
    for batch in loader:
        images = np.asarray(batch["image"])
        labels = np.asarray(batch["mask_label"])
        b = images.shape[0]
        gt_h = np.asarray(batch.get("mask_h", [labels.shape[1]] * b), np.int64)
        gt_w = np.asarray(batch.get("mask_w", [labels.shape[2]] * b), np.int64)
        if full_batch and b < full_batch:
            pad = full_batch - b
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate(
                [labels, np.full((pad,) + labels.shape[1:], 255, labels.dtype)])
            gt_h = np.concatenate([gt_h, np.ones(pad, np.int64)])
            gt_w = np.concatenate([gt_w, np.ones(pad, np.int64)])
        if labels.shape[1] > canvas or labels.shape[2] > canvas:
            raise ValueError(f"GT size {labels.shape[1:]} exceeds the {canvas} "
                             f"canvas for {dataset_name}")
        padded = np.full((labels.shape[0], canvas, canvas), 255, np.int64)
        padded[:, :labels.shape[1], :labels.shape[2]] = labels
        inter, union = forward(
            torch.from_numpy(images), text_bank, torch.from_numpy(padded),
            torch.from_numpy(gt_h), torch.from_numpy(gt_w))
        total_i += inter.double().cpu().numpy()
        total_u += union.double().cpu().numpy()
        count += b

    iou, miou = miou_from_totals(total_i, total_u)
    logger.info("%d samples evaluated; mIoU %.4f", count, miou)
    return iou, miou
