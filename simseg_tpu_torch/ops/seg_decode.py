"""Zero-shot segmentation decode (port of
``simseg_tpu/ops/seg_decode.py:make_seg_decode_fn``).

Parity: the reference's per-image eval loop ``tools/seg_evaluation.py:93-177``,
batched:
1. global image-text scores -> top-k class shortlist; threshold = mean +
   1.0 * std (ddof 1) of the top-k scores (:119-124)
2. up to 5 candidate classes; background id 0 / 255 and scores below the
   threshold are invalid (:129-147)
3. per candidate: patch/class-text similarity map, min-max normalised on the
   patch grid (normalisation commutes with the nearest upsample), unary
   difference ``du`` there, then x patch_size nearest upsample (:136-150)
4. mean-field CRF + 7x7 closing (:153-159), routed by shape as the JAX
   decode routes it (``simseg_tpu/ops/seg_decode.py:200-222``): on the
   card, where ``fused_eligible`` holds, one CUDA kernel runs both
   (``ops/crf_fused.mean_field_fused``); elsewhere ``dense_crf_batched_du``
   takes its auto lane (materialised K, or the streaming kernel past 4096
   cells) and ``morphology.closing`` follows. Float32 throughout.
5. score-weighted masks, argmax with first-occurrence ties (:160-177)

``crf_backend="fused_tail"`` is the JAX decode's opt-in lane (:162-189):
on the card, where ``fused_eligible`` holds, steps 4-5 and the nearest
upsample of step 3 run in one kernel (``ops/crf_fused.seg_decode_tail_fused``)
on the patch-grid unaries; elsewhere, and always on the CPU, it takes the
unfused chain on the materialised-K lane, as the JAX lane's default branch
does (its ``bilateral_impl="fused_tail"`` resolves to that lane). The JAX
decode's other knobs (the pinned ``crf_backend`` lanes "xla", "pallas"
and "fused", ``morphology_impl``, ``compute_dtype``) are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from simseg_tpu_torch.ops.crf import dense_crf_batched_du
from simseg_tpu_torch.ops.crf_fused import (fused_eligible, mean_field_fused,
                                            seg_decode_tail_fused)
from simseg_tpu_torch.ops.morphology import closing, nearest_upsample

# the decode lanes the port has of the JAX ``crf_backend`` knob
_CRF_BACKENDS = ("auto", "fused_tail")


def shortlist(pooled: torch.Tensor, text_bank: torch.Tensor, top_cls_num: int,
              candidate_classes: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1-2: (cand_idx (B, K) int64, cand_scores (B, K) f32, valid (B, K))."""
    scores = torch.matmul(pooled.float(), text_bank.float().T)      # (B, C)
    topk_scores, topk_idx = torch.topk(scores, top_cls_num, dim=-1,
                                       sorted=True)
    threshold = topk_scores.mean(dim=-1) + 1.0 * topk_scores.std(dim=-1,
                                                                 correction=1)
    cand_idx = topk_idx[:, :candidate_classes]
    cand_scores = topk_scores[:, :candidate_classes]
    valid = ((cand_idx != 0) & (cand_idx != 255)
             & (cand_scores >= threshold[:, None]))
    return cand_idx, cand_scores, valid


def coarse_unary(dense: torch.Tensor, text_bank: torch.Tensor,
                 cand_idx: torch.Tensor, grid: int) -> torch.Tensor:
    """Step 3 on the patch grid: (B, K, grid, grid) ``log p - log(1 - p)``
    of the min-max normalised similarity maps."""
    b, k = cand_idx.shape
    cand_emb = text_bank.float()[cand_idx]                          # (B, K, D)
    attn = torch.matmul(cand_emb, dense.float().transpose(1, 2))    # (B, K, N)
    attn = attn.reshape(b, k, grid, grid)
    amin = attn.amin(dim=(-2, -1), keepdim=True)
    amax = attn.amax(dim=(-2, -1), keepdim=True)
    probs = (attn - amin) / torch.clamp(amax - amin, min=1e-12)
    p = torch.clamp(probs, 0.0, 1.0)
    return torch.log(p + 1e-8) - torch.log(1.0 - p + 1e-8)


def decode_tail(masks: torch.Tensor, cand_idx: torch.Tensor,
                cand_scores: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 5: masks (B, K, H, W) -> (pred (B, H, W) int32, best weight f32).

    A running strict ``>`` over the K candidates is argmax's first-occurrence
    tie rule (``simseg_tpu/ops/seg_decode.py:117-134``); pred is 0 wherever
    no weight is positive."""
    weights = torch.where(valid[:, :, None, None],
                          masks * cand_scores[:, :, None, None],
                          torch.zeros((), device=masks.device))
    best_w = weights[:, 0]
    pred = cand_idx[:, 0, None, None].expand_as(best_w)
    for k in range(1, weights.shape[1]):
        upd = weights[:, k] > best_w
        pred = torch.where(upd, cand_idx[:, k, None, None], pred)
        best_w = torch.where(upd, weights[:, k], best_w)
    pred = torch.where(best_w > 0, pred, torch.zeros_like(pred))
    return pred.to(torch.int32), best_w


def make_seg_decode_fn(num_classes: int, image_size: int, patch_size: int = 16,
                       top_cls_num: int = 10, candidate_classes: int = 5,
                       crf_iters: int = 3, bilateral_stride: int = 8,
                       morphology_ksize: int = 7, crf_backend: str = "auto"):
    """Returns decode(dense, pooled, text_bank, raw_images) -> (pred, best_w):

    dense:      (B, N, D) per-token projected embeddings, L2-normalised
    pooled:     (B, D) global image embedding, L2-normalised
    text_bank:  (C, D) class text embeddings, L2-normalised
    raw_images: (B, H, W, 3) uint8 pixels, H = W = image_size
    pred:       (B, H, W) int32 class map (0 = background)
    best_w:     (B, H, W) f32 winning score * mask weight (0 where bg)

    All inputs on one device; the CRF runs where they lie. crf_backend:
    ``"auto"`` or ``"fused_tail"`` (see the module docstring).
    """
    if crf_backend not in _CRF_BACKENDS:
        raise ValueError(f"crf_backend {crf_backend!r}: the port has "
                         f"{_CRF_BACKENDS}")
    grid = image_size // patch_size
    top_cls_num = min(top_cls_num, num_classes)
    candidate_classes = min(candidate_classes, top_cls_num)

    def decode(dense, pooled, text_bank, raw_images):
        if dense.shape[1] != grid * grid:
            raise ValueError(f"{dense.shape[1]} tokens for a {grid}x{grid} grid")
        cand_idx, cand_scores, valid = shortlist(
            pooled, text_bank, top_cls_num, candidate_classes)
        du_coarse = coarse_unary(dense, text_bank, cand_idx, grid)
        on_card = du_coarse.device.type == "cuda" and fused_eligible(
            image_size, image_size, bilateral_stride)
        if crf_backend == "fused_tail" and on_card:
            scores_eff = torch.where(valid, cand_scores,
                                     torch.zeros_like(cand_scores))
            return seg_decode_tail_fused(
                du_coarse, raw_images, scores_eff, cand_idx,
                du_factor=patch_size, num_iters=crf_iters,
                stride=bilateral_stride, closing_ksize=morphology_ksize)
        du = nearest_upsample(du_coarse, patch_size).contiguous()
        if crf_backend == "fused_tail":
            masks = closing(dense_crf_batched_du(
                du, raw_images, num_iters=crf_iters,
                bilateral_stride=bilateral_stride,
                bilateral_impl="dense").float(), morphology_ksize)
        elif on_card:
            masks = mean_field_fused(du, raw_images, num_iters=crf_iters,
                                     stride=bilateral_stride,
                                     closing_ksize=morphology_ksize)
        else:
            masks = closing(dense_crf_batched_du(
                du, raw_images, num_iters=crf_iters,
                bilateral_stride=bilateral_stride).float(), morphology_ksize)
        return decode_tail(masks, cand_idx, cand_scores, valid)

    return decode
