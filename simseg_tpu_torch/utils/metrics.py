"""mIoU histograms (port of ``simseg_tpu/utils/metrics.py:20-102``).

Parity: reference ``simseg/utils/metrics.py:37-75`` (per-image intersect /
union histograms with an ignore index) and ``seg_evaluation.py:176-177``
(nan-mean IoU). The reference's ``label_map`` / ``reduce_zero_label`` knobs
are not used by segmentation eval and are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def intersect_and_union(
    pred: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(intersect, union, pred_area, label_area), each (num_classes,) f32.

    pred/label: integer maps of one shape. Pixels where
    ``label == ignore_index`` are excluded; ids outside ``[0, num_classes)``
    fall out of the histograms, as ``jnp.bincount(..., length=)`` drops them.
    """
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
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
