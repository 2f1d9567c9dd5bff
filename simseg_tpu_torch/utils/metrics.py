"""mIoU histograms and top-k accuracy (port of ``simseg_tpu/utils/metrics.py``).

Parity: reference ``simseg/utils/metrics.py:5-75`` (per-image intersect /
union histograms with an ignore index, ``label_map`` and
``reduce_zero_label``, accumulated over a list of images),
``seg_evaluation.py:176-177`` (nan-mean IoU) and ``misc.py:462-478``
(top-k accuracy).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def intersect_and_union(
    pred: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
    label_map: tuple = (),
    reduce_zero_label: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(intersect, union, pred_area, label_area), each (num_classes,) f32.

    pred/label: integer maps of one shape. Pixels where
    ``label == ignore_index`` are excluded; ids outside ``[0, num_classes)``
    fall out of the histograms, as ``jnp.bincount(..., length=)`` drops them.
    ``label_map``: ((old, new), ...) applied in order to the label as it is
    rewritten, so a later entry sees an earlier one's result (the reference
    rewrites in place, metrics.py:55-57). ``reduce_zero_label``: 0 is
    unlabelled (ignored) and every other id moves down by one, 255 staying
    ignored (metrics.py:58-61).
    """
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    for old_id, new_id in tuple(label_map):
        label = torch.where(label == old_id, new_id, label)
    if reduce_zero_label:
        label = torch.where(label == 0, 255, label) - 1
        label = torch.where(label == 254, 255, label)
    valid = label != ignore_index

    def hist(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        keep = mask & (x >= 0) & (x < num_classes)
        return torch.bincount(x[keep], minlength=num_classes)[:num_classes]

    area_intersect = hist(pred, valid & (pred == label))
    area_pred = hist(pred, valid)
    area_label = hist(label, valid)
    area_union = area_pred + area_label - area_intersect
    return (area_intersect.float(), area_union.float(), area_pred.float(),
            area_label.float())


def miou_from_totals(total_intersect: np.ndarray,
                     total_union: np.ndarray) -> Tuple[np.ndarray, float]:
    """Per-class IoU and their nan-mean."""
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = total_intersect / total_union
    return iou, float(np.nanmean(iou))


def mean_iou(results: Sequence[np.ndarray], gt_seg_maps: Sequence[np.ndarray],
             num_classes: int, ignore_index: int = 255, label_map=None,
             reduce_zero_label: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(intersection, union) float64 totals over a list of images (the
    caller divides and nan-means, ``miou_from_totals``). ``label_map``: the
    reference's dict (insertion order is the order applied) or ((old, new),
    ...)."""
    total_i = np.zeros((num_classes,), dtype=np.float64)
    total_u = np.zeros((num_classes,), dtype=np.float64)
    lmap = tuple(label_map.items() if isinstance(label_map, dict)
                 else (label_map or ()))
    for pred, label in zip(results, gt_seg_maps):
        i, u, _, _ = intersect_and_union(
            torch.as_tensor(np.asarray(pred)), torch.as_tensor(np.asarray(label)),
            num_classes, ignore_index, lmap, reduce_zero_label)
        total_i += i.double().cpu().numpy()
        total_u += u.double().cpu().numpy()
    return total_i, total_u


def top_k_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest entries' indices per row, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none, so a stable
    descending sort)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  ks: Sequence[int] = (1,)) -> list:
    """The share of rows whose target is among the top-k logits, one
    float32 scalar tensor a k; tied logits rank the lower index first."""
    match = top_k_ids(logits, max(ks)) == targets[:, None]
    return [match[:, :k].any(dim=1).float().mean() for k in ks]
