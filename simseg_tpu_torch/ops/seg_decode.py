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
   decode routes it (``simseg_tpu/ops/seg_decode.py:200-222``): where
   ``fused_eligible`` holds, one op runs both
   (``ops/crf_fused.mean_field_fused``: the CUDA kernel on the card, its
   plain version, the dense lane and the window closing, on the CPU);
   elsewhere ``dense_crf_batched_du`` takes its auto lane (materialised K,
   or the streaming kernel past 4096 cells) and the closing follows.
5. score-weighted masks, argmax with first-occurrence ties (:160-177)

The knobs are JAX's (``simseg_tpu/ops/seg_decode.py:130-223``), routed
as JAX routes them on the TPU with the card in the TPU's place:

- ``crf_backend``: ``"auto"`` (where ``fused_eligible`` holds and
  ``morphology_impl`` is ``"auto"`` too, the one-op CRF + closing above;
  otherwise the CRF's own auto lane), ``"xla"`` (the plain chain, the
  CRF's ``"dense"`` lane), ``"pallas"`` (the bilateral kernel, the CRF's
  ``"stream"`` lane), ``"fused"`` (the mean-field kernel without its
  closing, then the closing ``morphology_impl`` selects) and
  ``"fused_tail"`` (where ``fused_eligible`` holds, steps 3-5 in one op,
  ``ops/crf_fused.seg_decode_tail_fused``, on the patch-grid unaries;
  elsewhere the unfused chain on the dense lane, as JAX's default branch
  runs it). On the CPU every kernel lane runs its plain version, which
  gives the unfused chain's results there: so an exported graph holds the
  same ops on both devices.
- ``morphology_impl``: ``"window"`` (``morphology.closing``),
  ``"matmul"`` (``morphology.binary_closing_matmul``, exact on the 0/1
  masks) or ``"auto"`` (matmul on the card, window elsewhere).
- ``compute_dtype``: ``"auto"`` and ``"float32"`` compute in float32 (the
  port's auto is float32 on every device, where JAX's is bf16 on the TPU:
  whether the card's should be bf16 is a speed question the benchmark has
  to answer); ``"bfloat16"`` computes every lane in bf16, the kernels'
  lanes through their bf16 modes (``ops/crf_fused.py``) on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from simseg_tpu_torch.ops.crf import dense_crf_batched_du
from simseg_tpu_torch.ops.crf_fused import (fused_eligible, mean_field_fused,
                                            seg_decode_tail_fused)
from simseg_tpu_torch.ops.morphology import (binary_closing_matmul, closing,
                                             nearest_upsample)

CRF_BACKENDS = ("auto", "xla", "pallas", "fused", "fused_tail")
MORPHOLOGY_IMPLS = ("auto", "window", "matmul")
COMPUTE_DTYPES = ("auto", "float32", "bfloat16")
# JAX's crf_backend names -> the CRF's lane names (ops/crf.py)
_CRF_LANES = {"auto": "auto", "xla": "dense", "pallas": "stream",
              "fused": "fused", "fused_tail": "dense"}


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
                       morphology_ksize: int = 7,
                       morphology_impl: str = "auto",
                       crf_backend: str = "auto",
                       compute_dtype: str = "auto"):
    """Returns decode(dense, pooled, text_bank, raw_images) -> (pred, best_w):

    dense:      (B, N, D) per-token projected embeddings, L2-normalised
    pooled:     (B, D) global image embedding, L2-normalised
    text_bank:  (C, D) class text embeddings, L2-normalised
    raw_images: (B, H, W, 3) uint8 pixels, H = W = image_size
    pred:       (B, H, W) int32 class map (0 = background)
    best_w:     (B, H, W) f32 winning score * mask weight (0 where bg)

    All inputs on one device; the CRF runs where they lie. The knobs
    ``crf_backend``, ``morphology_impl`` and ``compute_dtype`` are JAX's
    (see the module docstring).
    """
    for name, value, allowed in (("crf_backend", crf_backend, CRF_BACKENDS),
                                 ("morphology_impl", morphology_impl,
                                  MORPHOLOGY_IMPLS),
                                 ("compute_dtype", compute_dtype,
                                  COMPUTE_DTYPES)):
        if value not in allowed:
            raise ValueError(f"{name} {value!r}: one of {allowed}")
    bf16 = compute_dtype == "bfloat16"
    kernel_dtype = "bfloat16" if bf16 else "float32"
    grid = image_size // patch_size
    top_cls_num = min(top_cls_num, num_classes)
    candidate_classes = min(candidate_classes, top_cls_num)
    eligible = fused_eligible(image_size, image_size, bilateral_stride)

    def decode(dense, pooled, text_bank, raw_images):
        if dense.shape[1] != grid * grid:
            raise ValueError(f"{dense.shape[1]} tokens for a {grid}x{grid} grid")
        on_card = dense.device.type == "cuda"
        cand_idx, cand_scores, valid = shortlist(
            pooled, text_bank, top_cls_num, candidate_classes)
        du_coarse = coarse_unary(dense, text_bank, cand_idx, grid)
        if crf_backend == "fused_tail" and eligible:
            scores_eff = torch.where(valid, cand_scores,
                                     torch.zeros_like(cand_scores))
            return seg_decode_tail_fused(
                du_coarse, raw_images, scores_eff, cand_idx,
                du_factor=patch_size, num_iters=crf_iters,
                stride=bilateral_stride, closing_ksize=morphology_ksize,
                compute_dtype=kernel_dtype)
        du = nearest_upsample(du_coarse, patch_size).contiguous()
        # bf16 on the CPU keeps the plain chain in bf16, as JAX's default
        # branch does
        if (crf_backend == "auto" and morphology_impl == "auto" and eligible
                and (on_card or not bf16)):
            masks = mean_field_fused(du, raw_images, num_iters=crf_iters,
                                     stride=bilateral_stride,
                                     closing_ksize=morphology_ksize,
                                     compute_dtype=kernel_dtype)
            return decode_tail(masks.float(), cand_idx, cand_scores, valid)
        # the unfused chain (JAX ``_unfused(on_tpu)``, with on_tpu read as
        # on the card)
        masks = dense_crf_batched_du(
            du, raw_images, num_iters=crf_iters,
            bilateral_stride=bilateral_stride,
            bilateral_impl=_CRF_LANES[crf_backend],
            compute_dtype=compute_dtype)
        impl = (morphology_impl if morphology_impl != "auto"
                else ("matmul" if on_card else "window"))
        op = binary_closing_matmul if impl == "matmul" else closing
        masks = masks.to(torch.bfloat16 if bf16 else torch.float32)
        return decode_tail(op(masks, morphology_ksize).float(), cand_idx,
                           cand_scores, valid)

    return decode
