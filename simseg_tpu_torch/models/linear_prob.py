"""Linear probing: a frozen image tower and a linear classifier (port of
``simseg_tpu/models/linear_prob.py``).

Parity: reference ``simseg/models/pipelines/linear_prob.py:11-104`` — a
ViT (CLS-token or patch-mean features) or CNN tower (its map mean-pooled,
``global_pool='avg'``), a Linear classifier, CE loss. The tower sits under
the reference's names (``image_encoder.model.model``, as in ``CLIPModel``),
so ``ckpt.external_resume`` with ``only_load_image_encoder`` loads a
pretrained SimSeg ``.pth`` into it; the classifier is ``classifier``.

A frozen tower (``encoder_trainable=False``) runs under ``torch.no_grad()``
and in eval mode whatever the model's mode (JAX's ``stop_gradient`` on its
features): a probe's batch keeps no tower activations, dropout is off and
a CNN's BatchNorm reads its running statistics, which never move. Logits
come out in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from simseg_tpu_torch.models.clip import PIPELINE, _Wrapper
from simseg_tpu_torch.models.layers import Linear
from simseg_tpu_torch.ops.losses import label_smoothing_ce, soft_target_ce
from simseg_tpu_torch.utils.metrics import top_k_ids


class LinearProbModel(nn.Module):
    def __init__(self, image_tag: str = "vit_base_patch16_224_in21k",
                 img_size: int = 224, num_classes: int = 1000,
                 only_cls_token: bool = True, encoder_trainable: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 image_arch: Optional[dict] = None) -> None:
        super().__init__()
        arch = dict(image_arch or {})
        if "vit" in image_tag:
            from simseg_tpu_torch.models.vit import build_vit

            encoder = build_vit(image_tag, img_size, arch)
            width = encoder.embed_dim
        else:
            from simseg_tpu_torch.models.cnn import build_cnn

            encoder = build_cnn(image_tag, arch)
            width = encoder.num_features
        encoder.compute_dtype = compute_dtype
        self.image_encoder = _Wrapper(_Wrapper(encoder))
        self.classifier = Linear(width, num_classes)
        nn.init.zeros_(self.classifier.bias)    # flax Dense's zeros
        self.only_cls_token = only_cls_token
        self.encoder_trainable = encoder_trainable

    @property
    def image_tower(self) -> nn.Module:
        return self.image_encoder.model.model

    def _tower(self, images: torch.Tensor, key=None) -> torch.Tensor:
        if self.encoder_trainable:
            return self.image_tower(images, key)
        tower = self.image_tower
        was_training = tower.training
        tower.eval()
        try:
            with torch.no_grad():
                return tower(images)
        finally:
            tower.train(was_training)

    def forward_image_feature(self, images: torch.Tensor,
                              key=None) -> torch.Tensor:
        feats = self._tower(images, key)
        if feats.ndim == 4:         # a CNN map -> global average pool
            return feats.mean((1, 2))
        if self.only_cls_token:
            return feats[:, 0]
        return feats[:, 1:].mean(1)

    def forward(self, batch: Dict[str, torch.Tensor], key=None) -> torch.Tensor:
        """(B, num_classes) float32 logits of ``batch["image"]`` (B, H, W, 3)."""
        return self.classifier(
            self.forward_image_feature(batch["image"], key)).float()


def linear_prob_loss_fn(model, batch: Dict[str, torch.Tensor], key=None,
                        smoothing: float = 0.0, soft_targets: bool = False
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE loss and top-1 / top-5 accuracy (JAX ``linear_prob_loss_fn``;
    parity: linear_prob.py:56-70). ``label``: int class ids, or with
    ``soft_targets`` (B, C) probabilities (mixup), scored against their
    argmax."""
    logits = model(batch, key)
    labels = batch["label"]
    if soft_targets and labels.ndim == 2:
        loss = soft_target_ce(logits, labels).mean()
        hard = labels.argmax(-1)
    else:
        loss = label_smoothing_ce(logits, labels, smoothing).mean()
        hard = labels
    match = top_k_ids(logits, min(5, logits.shape[-1])) == hard[:, None]
    acc1 = match[:, 0].float().mean()
    acc5 = match.any(1).float().mean()
    return loss, {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}


@PIPELINE.register(name="linear_prob")
def build_linear_prob_model(cfg) -> LinearProbModel:
    """The probe of a config tree (JAX ``build_linear_prob_model``), float32
    parameters, computing in bf16 under ``dist.bf16``, with JAX's two
    refusals."""
    enc = cfg.model.image_encoder
    arch = {k: v for k, v in dict(enc.get("arch", {}) or {}).items()
            if v is not None}
    trainable = enc.trainable
    if trainable and arch.get("quant", "none") not in (None, "", "none"):
        raise NotImplementedError(
            "arch quant is inference-only: set "
            "model.image_encoder.trainable=false for a quantized probe")
    if trainable and int(arch.get("moe_experts", 0) or 0) > 0:
        raise NotImplementedError(
            "linear probing does not train MoE towers (no aux balancing "
            "loss here) — freeze the encoder or use the clip task")
    return LinearProbModel(
        image_tag=enc.tag,
        img_size=cfg.transforms.input_size,
        num_classes=cfg.model.classifier.num_classes,
        only_cls_token=enc.vit.get("only_cls_token", True),
        encoder_trainable=trainable,
        compute_dtype=torch.bfloat16 if cfg.dist.get("bf16", False) else None,
        image_arch=arch,
    )
