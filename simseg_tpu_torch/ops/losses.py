"""Contrastive and classification losses as plain functions (port of
``simseg_tpu/ops/losses.py``).

Parity: reference ``simseg/models/criteria/losses/mml_loss.py`` — NCE
(:12-103), MixUpNCE (:105-197), MSE (:200-253), Triplet (:256-347),
LabelSmoothingCrossEntropy (:350-377), SoftTargetCrossEntropy (:379-391).
Like the JAX version, the losses take the global batch: over ranks the
train step all-gathers the embeddings first (``engine/train_step.py``, the
reference's GatherLayer). Group-limited negatives (``group_size``) are a
block-diagonal reshape. Logits are
float32 whatever the embeddings' dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    """Per-row smoothed CE (parity: mml_loss.py:350-377). targets: int (N,)."""
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -logprobs.gather(-1, targets[:, None].long())[:, 0]
    smooth = -logprobs.mean(dim=-1)
    return (1.0 - smoothing) * nll + smoothing * smooth


def soft_target_ce(logits: torch.Tensor,
                   target_probs: torch.Tensor) -> torch.Tensor:
    """Per-row CE against a soft target distribution (mml_loss.py:379-391)."""
    return -(target_probs * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def _top1_acc(logits: torch.Tensor, targets: torch.Tensor,
              row_valid: Optional[torch.Tensor]) -> torch.Tensor:
    with torch.no_grad():
        hit = (logits.argmax(dim=-1) == targets).float()
        if row_valid is None:
            return hit.mean()
        w = row_valid.float()
        return (hit * w).sum() / torch.clamp(w.sum(), min=1.0)


def _ignore(feat: torch.Tensor, ignore_mask: Optional[torch.Tensor]) -> torch.Tensor:
    n = feat.shape[0]
    if ignore_mask is None:
        return torch.zeros((n,), dtype=feat.dtype, device=feat.device)
    return ignore_mask.to(feat.dtype)


def _logits(feat1: torch.Tensor, feat2: torch.Tensor, temperature,
            group_size: int) -> torch.Tensor:
    """(N, N) f32 logits, or (N, group_size) within contiguous groups."""
    n = feat1.shape[0]
    f1, f2 = feat1.float(), feat2.float()
    if group_size and 0 < group_size < n:
        if n % group_size != 0:
            raise ValueError(f"group_size {group_size} must divide batch {n}")
        g = n // group_size
        logits = torch.einsum("gnd,gmd->gnm", f1.reshape(g, group_size, -1),
                              f2.reshape(g, group_size, -1))
        return logits.reshape(n, group_size) / temperature
    return f1 @ f2.T / temperature


def info_nce(feat1: torch.Tensor, feat2: torch.Tensor, temperature,
             ignore_mask: Optional[torch.Tensor] = None, smoothing: float = 0.0,
             group_size: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-directional global InfoNCE (parity: mml_loss.py:51-96). feat1,
    feat2: (N, D), L2-normalised; temperature: clamped scalar. Masked feat2
    rows are zeroed and masked loss rows zeroed but still counted in the
    mean (the reference's behaviour). Returns (loss, top-1 accuracy over the
    rows not ignored)."""
    n = feat1.shape[0]
    ignore = _ignore(feat1, ignore_mask)
    feat2 = feat2 * (1.0 - ignore)[:, None]
    logits = _logits(feat1, feat2, temperature, group_size)
    cols = logits.shape[1]
    targets = torch.arange(n, device=feat1.device) % cols
    per_row = label_smoothing_ce(logits, targets, smoothing)
    acc = _top1_acc(logits, targets, ignore < 1)
    return (per_row * (1.0 - ignore)).mean(), acc


def symmetric_info_nce(image_emb: torch.Tensor, text_emb: torch.Tensor,
                       temperature, ignore_mask: Optional[torch.Tensor] = None,
                       smoothing: float = 0.0, group_size: int = -1
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """0.5 * (i2t + t2i) (parity: pipelines/clip.py:123-149 forward_loss)."""
    i2t, i2t_acc = info_nce(image_emb, text_emb, temperature, ignore_mask,
                            smoothing, group_size)
    t2i, t2i_acc = info_nce(text_emb, image_emb, temperature, ignore_mask,
                            smoothing, group_size)
    return 0.5 * (i2t + t2i), {"i2t_acc": i2t_acc, "t2i_acc": t2i_acc}


def mixup_nce(feat1: torch.Tensor, feat2: torch.Tensor, temperature, alpha,
              flip_block: int, ignore_mask: Optional[torch.Tensor] = None,
              smoothing: float = 0.0, group_size: int = -1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE with single-modality mixup (parity: mml_loss.py:146-197):
    ``alpha CE(logits, targets) + (1 - alpha) CE(logits, flip_targets)``,
    flip targets reversing each block of ``flip_block`` rows. With
    ``group_size`` the flip blocks must nest inside the groups."""
    n = feat1.shape[0]
    ignore = _ignore(feat1, ignore_mask)
    feat2 = feat2 * (1.0 - ignore)[:, None]
    targets = torch.arange(n, device=feat1.device)
    flip_targets = (targets // flip_block * flip_block
                    + (flip_block - 1 - targets % flip_block))
    if group_size and 0 < group_size < n:
        if group_size % flip_block != 0:
            raise ValueError(
                f"mixup flip blocks must nest inside group_size groups: "
                f"flip {flip_block}, group {group_size}")
        targets, flip_targets = targets % group_size, flip_targets % group_size
    logits = _logits(feat1, feat2, temperature, group_size)
    per_row = (alpha * label_smoothing_ce(logits, targets, smoothing)
               + (1 - alpha) * label_smoothing_ce(logits, flip_targets, smoothing))
    acc = _top1_acc(logits, targets, ignore < 1)
    return (per_row * (1.0 - ignore)).mean(), acc


def mse_embedding_loss(feat1_sim: torch.Tensor, feat2: torch.Tensor,
                       feat1: Optional[torch.Tensor] = None,
                       ignore_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding regression with a no-grad NCE accuracy probe (parity:
    mml_loss.py:224-253, including the scalar MSE scaled by
    mean(1 - ignore_mask)); feat1 defaults to feat1_sim."""
    if feat1 is None:
        feat1 = feat1_sim
    n = feat1.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=feat1.device)
         if ignore_mask is None else 1.0 - ignore_mask.float())
    loss = ((feat1_sim - feat2) ** 2).mean() * w.mean()
    logits = (feat1.float() @ feat2.float().T).detach()
    acc = _top1_acc(logits, torch.arange(n, device=feat1.device), w > 0)
    return loss, acc


def triplet_loss(feat1: torch.Tensor, feat2: torch.Tensor, margin: float = 0.2,
                 reduce_mode: str = "max"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional margin ranking loss (parity: mml_loss.py:316-347; 'max'
    takes the hardest negative, 'mean' averages over the n - 1)."""
    n = feat1.shape[0]
    scores = feat1.float() @ feat2.float().T
    diag = torch.diagonal(scores)
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    zero = scores.new_zeros(())
    l12 = torch.where(eye, zero, torch.clamp(margin + scores - diag[:, None], min=0.0))
    l21 = torch.where(eye, zero, torch.clamp(margin + scores - diag[None, :], min=0.0))
    if reduce_mode == "mean":
        l12, l21 = l12.sum(dim=1) / (n - 1), l21.sum(dim=0) / (n - 1)
    elif reduce_mode == "max":
        l12, l21 = l12.amax(dim=1), l21.amax(dim=0)
    else:
        raise NotImplementedError(reduce_mode)
    targets = torch.arange(n, device=scores.device)
    return ((l12 + l21).sum(), _top1_acc(scores, targets, None),
            _top1_acc(scores.T, targets, None))
