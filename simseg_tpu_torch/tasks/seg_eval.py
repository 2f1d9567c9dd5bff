"""Zero-shot semantic segmentation evaluation (port of
``simseg_tpu/tasks/seg_eval.py``).

Parity: reference ``tools/seg_evaluation.py`` —
- zero_shot_classifier (:57-75): per class, embed the 80 OpenAI prompts
  through the text tower, mean, L2-normalise
- evaluate_benchmark (:78-181): per batch, towers + decode + GT-size nearest
  resize + mIoU accumulation

The options the JAX version reads from its config tree are keywords here
(``input_size``, ``mean``, ``std``, ``bilateral_stride``, ``max_length``,
``top_cls_num``, ``scales``, ``window_size``, ``window_stride`` for its
``seg_eval.scales`` / ``seg_eval.window`` multi-scale and sliding-window
dense inference, and ``crf_backend`` for ``seg_eval.crf_backend``, "auto"
or "fused_tail", see ``ops/seg_decode.py``). int8 towers and multi-process
sharding are not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize_images
from simseg_tpu_torch.ops.interpolate_pe import resize_bilinear
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


def make_seg_features(model, *, input_size: int,
                      mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD,
                      patch_size: Optional[int] = None,
                      scales: Sequence[float] = (1.0,), window_size: int = -1,
                      window_stride: int = -1, device=None):
    """``features(images_u8) -> (dense (B, N, D), pooled (B, D))``, both
    L2-normalised float32, on ``device`` (the model must be there): the
    normalisation and the towers of JAX ``make_seg_predict``
    (``simseg_tpu/tasks/seg_eval.py:175-316``), N the patch grid of
    ``input_size``.

    scales: the image is also encoded at each scale != 1.0 (size snapped to
    the patch grid); every scale's patch features are resampled bilinearly
    onto the base grid and averaged, and the pooled embeddings averaged.
    ``(1.0,)`` is the reference's single-scale pipeline.
    window_size / window_stride: when 0 < window_size < input_size, the
    tower runs on window_size crops at window_stride (default: the size),
    and the crops' patch features are scatter-averaged onto the full grid.
    """
    device = resolve_device(device)
    patch_size = patch_size or model.patch_size
    scales = tuple(scales)
    base_grid = input_size // patch_size
    use_window = 0 < window_size < input_size
    multi_scale = len(scales) > 1 or scales[0] != 1.0

    def tower(images):
        patches = model.forward_image_tokens(images)[:, 1:]
        pooled = model.forward_image_project(patches).float()
        return model.project_image_tokens(patches).float(), pooled

    def sliding_tower(images):
        b = images.shape[0]
        stride = window_stride if window_stride > 0 else window_size
        starts = sorted({min(y, input_size - window_size) for y in
                         range(0, input_size - window_size + stride, stride)})
        wg = window_size // patch_size
        corners = [(y0, x0) for y0 in starts for x0 in starts]
        # all windows through the tower as one batch (one launch sequence
        # instead of one per window), accumulated in the JAX loop's order
        dense_all, pooled_all = tower(torch.cat(
            [images[:, y0:y0 + window_size, x0:x0 + window_size]
             for y0, x0 in corners]))
        d = dense_all.shape[-1]
        feat_grid = torch.zeros((b, base_grid, base_grid, d),
                                device=images.device)
        counts = torch.zeros((1, base_grid, base_grid, 1), device=images.device)
        pooled_acc = torch.zeros_like(pooled_all[:b])
        for i, (y0, x0) in enumerate(corners):
            gy, gx = y0 // patch_size, x0 // patch_size
            feat_grid[:, gy:gy + wg, gx:gx + wg] += dense_all[
                i * b:(i + 1) * b].reshape(b, wg, wg, d)
            counts[:, gy:gy + wg, gx:gx + wg] += 1.0
            pooled_acc += pooled_all[i * b:(i + 1) * b]
        dense = (feat_grid / torch.clamp(counts, min=1.0)).reshape(b, -1, d)
        # the window MEAN of the pooled embeddings; features re-normalises
        return dense, pooled_acc / len(corners)

    @torch.no_grad()
    def features(images_u8: torch.Tensor):
        images = normalize_images(images_u8.to(device), mean, std)
        if use_window:
            dense, pooled = sliding_tower(images)
            if multi_scale and model.projection_name == "simple":
                # each window's pooled is unit-norm, their mean is not: the
                # views below enter the average at unit norm (JAX :279-286)
                pooled = l2_normalize(pooled)
        else:
            dense, pooled = tower(images)
        if multi_scale:
            b, _, d = dense.shape
            seeded = 1.0 in scales
            dense_acc = dense if seeded else torch.zeros_like(dense)
            pooled_acc = pooled if seeded else torch.zeros_like(pooled)
            n_used = 1 if seeded else 0
            for scale in scales:
                if scale == 1.0:
                    continue
                size_s = max(int(round(input_size * scale / patch_size)),
                             1) * patch_size
                grid_s = size_s // patch_size
                dense_s, pooled_s = tower(resize_bilinear(images, size_s,
                                                          size_s))
                grid_feats = resize_bilinear(
                    dense_s.reshape(b, grid_s, grid_s, d), base_grid, base_grid)
                dense_acc = dense_acc + grid_feats.reshape(b, -1, d)
                pooled_acc = pooled_acc + pooled_s
                n_used += 1
            dense = dense_acc / n_used
            pooled = l2_normalize(pooled_acc / n_used)
        elif use_window:
            pooled = l2_normalize(pooled)
        return l2_normalize(dense), pooled

    return features


def make_seg_predict(model, num_classes: int, top_cls_num: int, *,
                     input_size: int, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD,
                     bilateral_stride: int = 8,
                     patch_size: Optional[int] = None,
                     scales: Sequence[float] = (1.0,), window_size: int = -1,
                     window_stride: int = -1, crf_backend: str = "auto",
                     device=None):
    """``predict(images_u8, text_bank) -> (pred, best_w)`` on ``device``
    (the model must be there): ``make_seg_features`` (the same keywords),
    then the decode on the ``input_size`` canvas (``crf_backend`` as
    ``make_seg_decode_fn`` takes it)."""
    device = resolve_device(device)
    patch_size = patch_size or model.patch_size
    features = make_seg_features(
        model, input_size=input_size, mean=mean, std=std,
        patch_size=patch_size, scales=scales, window_size=window_size,
        window_stride=window_stride, device=device)
    decode = make_seg_decode_fn(
        num_classes=num_classes, image_size=input_size, patch_size=patch_size,
        top_cls_num=top_cls_num, candidate_classes=5,
        bilateral_stride=bilateral_stride, crf_backend=crf_backend)

    @torch.no_grad()
    def predict(images_u8: torch.Tensor, text_bank: torch.Tensor):
        images_u8, text_bank = images_u8.to(device), text_bank.to(device)
        dense, pooled = features(images_u8)
        return decode(dense, pooled, text_bank, images_u8)

    return predict


def make_seg_forward(model, num_classes: int, top_cls_num: int, canvas: int, *,
                     input_size: int, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD,
                     bilateral_stride: int = 8,
                     patch_size: Optional[int] = None,
                     scales: Sequence[float] = (1.0,), window_size: int = -1,
                     window_stride: int = -1, crf_backend: str = "auto",
                     return_pred: bool = False, device=None):
    """``forward(images_u8, text_bank, labels_padded, gt_h, gt_w) ->
    (intersection, union[, resized preds])`` on ``device``:
    ``make_seg_predict`` plus the per-image nearest resize to the GT size
    inside the (canvas, canvas) label canvas and the confusion histograms."""
    device = resolve_device(device)
    predict = make_seg_predict(model, num_classes, top_cls_num,
                               input_size=input_size, mean=mean, std=std,
                               bilateral_stride=bilateral_stride,
                               patch_size=patch_size, scales=scales,
                               window_size=window_size,
                               window_stride=window_stride,
                               crf_backend=crf_backend, device=device)

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


def label_canvas(loader, dataset_name: str) -> int:
    """The padded GT canvas: the dataset's default, raised to the largest
    GT side rounded up to 64 where the loader's dataset can pre-scan its
    labels (JAX ``evaluate_benchmark``, ``simseg_tpu/tasks/seg_eval.py:376-389``),
    so an oversized label grows the canvas before the first batch instead
    of failing mid-dataset."""
    canvas = GT_CANVAS.get(dataset_name, 640)
    dataset = getattr(loader, "dataset", None)
    if dataset is not None and hasattr(dataset, "max_label_size"):
        need = max(dataset.max_label_size())
        if need > canvas:
            new_canvas = int(-(-need // 64) * 64)
            logger.warning("%s GT labels reach %dpx > the %dpx canvas; "
                           "raising the padded canvas to %dpx", dataset_name,
                           need, canvas, new_canvas)
            canvas = new_canvas
    return canvas


def evaluate_benchmark(loader: Iterable[dict], model, tokenizer,
                       seg_categories: Sequence[str], top_cls_num: int,
                       dataset_name: str, *, input_size: int,
                       mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD,
                       bilateral_stride: int = 8, max_length: int = 25,
                       scales: Sequence[float] = (1.0,), window_size: int = -1,
                       window_stride: int = -1, crf_backend: str = "auto",
                       device=None) -> Tuple[np.ndarray, float]:
    """Dataset mIoU. Returns (per-class IoU, mIoU). Moves ``model`` to
    ``device`` and into eval mode.

    loader: any iterable of batch dicts with ``image`` uint8 (B, S, S, 3),
    ``mask_label`` (B, H, W) 255-padded, and optionally ``mask_h`` /
    ``mask_w``. When it has a ``batch_size``, a ragged last batch is padded
    to it with all-255 labels, as the JAX version pads to its compiled shape.
    When it has a ``dataset`` with ``max_label_size()``, the label canvas is
    raised up front to the largest GT side, rounded up to 64.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    num_classes = len(seg_categories)
    canvas = label_canvas(loader, dataset_name)
    logger.info("Building zero-shot classifier for %d classes", num_classes)
    text_bank = zero_shot_classifier(model, seg_categories, tokenizer,
                                     max_length=max_length, device=device)
    forward = make_seg_forward(model, num_classes, top_cls_num, canvas,
                               input_size=input_size, mean=mean, std=std,
                               bilateral_stride=bilateral_stride,
                               scales=scales, window_size=window_size,
                               window_stride=window_stride,
                               crf_backend=crf_backend, device=device)

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
