"""Two-tower CLIP model: ViT image tower + BERT text tower + projections +
LoDA pooling + temperature (port of ``simseg_tpu/models/clip.py``).

Parity: reference ``simseg/models/pipelines/clip.py:13-229``. The module
tree carries the reference's state-dict names (``image_encoder.model.model``
is the timm ViT, ``text_encoder.model.model`` the HF BERT, both two wrappers
deep as in the reference; ``loss.temperature``), so the state dict that
``checkpoint/convert.py`` makes, or a reference ``.pth``, loads with
``strict=True``. Only ViT image towers are ported; the CNN towers are not.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from simseg_tpu_torch.models.bert import build_bert
from simseg_tpu_torch.models.projection import ComplexProjection, SimpleProjection
from simseg_tpu_torch.models.vit import build_vit
from simseg_tpu_torch.ops.pooling import avg_pool, l2_normalize, topk_pool


class _Wrapper(nn.Module):
    """One level of the reference's ``.model`` nesting."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model


class CLIPModel(nn.Module):
    def __init__(
        self,
        image_tag: str = "vit_base_patch16_224_in21k",
        img_size: int = 224,
        image_arch: Optional[Tuple[Tuple[str, Any], ...]] = None,
        text_tag: str = "bert-base-uncased",
        text_arch: Optional[Tuple[Tuple[str, Any], ...]] = None,
        target_token_idx: int = 0,
        projection_name: str = "simple",
        projection_dim: int = 512,
        pool_name: str = "loda",
        image_k: int = 5,
        text_k: int = 1,
        temperature_name: str = "parameter",
        temperature_init: float = 0.02,
    ) -> None:
        super().__init__()
        if "vit" not in image_tag:
            raise NotImplementedError(
                f"image tower '{image_tag}': only ViT towers are ported")
        vit = build_vit(image_tag, img_size, dict(image_arch or ()))
        bert = build_bert(text_tag, dict(text_arch or ()))
        self.image_encoder = _Wrapper(_Wrapper(vit))
        self.text_encoder = _Wrapper(_Wrapper(bert))
        proj = {"simple": SimpleProjection, "complex": ComplexProjection}
        if projection_name not in proj:
            raise NotImplementedError(f"projection '{projection_name}'")
        self.image_projection = proj[projection_name](vit.embed_dim,
                                                      projection_dim)
        text_dim = bert.embeddings.word_embeddings.embedding_dim
        self.text_projection = proj[projection_name](text_dim, projection_dim)
        self.projection_name = projection_name
        self.pool_name = pool_name
        self.image_k = image_k
        self.text_k = text_k
        self.target_token_idx = target_token_idx
        self.temperature_name = temperature_name
        self.temperature_init = temperature_init
        if temperature_name == "parameter":
            self.loss = nn.Module()
            self.loss.temperature = nn.Parameter(
                torch.tensor(temperature_init, dtype=torch.float32))
        elif temperature_name != "constant":
            raise NotImplementedError(f"temperature '{temperature_name}'")

    @property
    def vit(self) -> nn.Module:
        return self.image_encoder.model.model

    @property
    def bert(self) -> nn.Module:
        return self.text_encoder.model.model

    @property
    def patch_size(self) -> int:
        return self.vit.patch_size

    # -- temperature -----------------------------------------------------------
    def temperature(self) -> torch.Tensor:
        """Clamped temperature (parity: mml_loss.py:56)."""
        if self.temperature_name == "parameter":
            t = self.loss.temperature
        else:
            t = torch.tensor(self.temperature_init, dtype=torch.float32)
        return torch.clamp(t, 0.001, 0.5)

    # -- image tower -------------------------------------------------------------
    def forward_image_feature(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> CLS (B, D) for identity pooling, else the patch
        tokens (B, N, D)."""
        tokens = self.vit(images)
        if self.pool_name == "identity":
            return tokens[:, 0]
        return tokens[:, 1:]

    def forward_image_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """Full (B, 1+N, D) sequence (seg eval needs CLS + patches)."""
        return self.vit(images)

    def forward_image_project(self, image_features: torch.Tensor) -> torch.Tensor:
        x = self.image_projection(image_features)
        if self.pool_name == "loda":
            x = topk_pool(x, self.image_k)
        elif self.pool_name == "avg":
            x = avg_pool(x)
        if self.projection_name == "simple":
            x = l2_normalize(x)
        return x

    def project_image_tokens(self, image_features: torch.Tensor) -> torch.Tensor:
        """Per-token projection without pooling (dense seg maps)."""
        return self.image_projection(image_features)

    # -- text tower ---------------------------------------------------------------
    def forward_text_feature(self, input_ids: torch.Tensor,
                             attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.bert(input_ids, attention_mask)
        if self.pool_name == "identity":
            return hidden[:, self.target_token_idx]
        return hidden[:, self.target_token_idx:]

    def forward_text_project(self, text_features: torch.Tensor,
                             attention_mask: Optional[torch.Tensor]
                             ) -> torch.Tensor:
        x = self.text_projection(text_features)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, self.target_token_idx:]
        if self.pool_name == "loda":
            x = topk_pool(x, self.text_k, mask)
        elif self.pool_name == "avg":
            x = avg_pool(x, mask)
        if self.projection_name == "simple":
            x = l2_normalize(x)
        return x
