"""Two-tower CLIP model: ViT image tower + BERT text tower + projections +
LoDA pooling + temperature (port of ``simseg_tpu/models/clip.py``).

Parity: reference ``simseg/models/pipelines/clip.py:13-229``. The module
tree carries the reference's state-dict names (``image_encoder.model.model``
is the timm ViT, ``text_encoder.model.model`` the HF BERT, both two wrappers
deep as in the reference; ``loss.temperature``), so the state dict that
``checkpoint/convert.py`` makes, or a reference ``.pth``, loads with
``strict=True``. The image tower is a ViT, or a CNN (``models/cnn.py``:
ResNet, ConvNeXt, EfficientNet) whose (B, h, w, C) map becomes h·w tokens
(reference ``pipelines/clip.py:79-82``); ``forward(..., train_bn=True)``
runs its BatchNorm on the batch's statistics and moves the running ones
(the reference's ``freeze_cnn_bn=False``).

Mixed precision as in the JAX package: parameters stay float32 (the
temperature always) and the towers compute in ``compute_dtype`` (bf16
under ``dist.bf16``), weights cast at use; ``compute_dtype=None`` computes
in the parameters' own dtype, so ``model.to(torch.bfloat16)`` still gives
the bf16 inference lane.

Training options as in JAX: ``dropout`` (the towers' rate; JAX's
``build_clip_model`` never sets it, nor does this one) and ``remat`` /
``remat_policy`` (read from ``model.remat`` / ``model.remat_policy``). A
non-deterministic forward takes a dropout key (``models/layers.py``) that
the train step derives from the run's seed and step (and BSGS from the
micro-batch too); the model's dropout sites are numbered once, across both
towers and the projections, so each draws its own mask from that key.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from simseg_tpu_torch.models.bert import build_bert
from simseg_tpu_torch.models.cnn import build_cnn
from simseg_tpu_torch.models.layers import number_dropout_sites
from simseg_tpu_torch.models.projection import ComplexProjection, SimpleProjection
from simseg_tpu_torch.models.vit import build_vit
from simseg_tpu_torch.ops.pooling import avg_pool, l2_normalize, topk_pool
from simseg_tpu_torch.utils.registry import Registry

# model factories by name (JAX ``PIPELINE``, ``simseg_tpu/models/clip.py:33``)
PIPELINE = Registry("PIPELINE")


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
        projection_dropout: float = 0.1,
        compute_dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        remat: bool = False,
        remat_policy: str = "none",
    ) -> None:
        super().__init__()
        train_kw = dict(dropout=dropout, remat=remat, remat_policy=remat_policy)
        self.dropout, self.projection_dropout = dropout, projection_dropout
        self.image_arch, self.text_arch = image_arch, text_arch
        self.is_vit = "vit" in image_tag
        if self.is_vit:
            image = build_vit(image_tag, img_size, dict(image_arch or ()),
                              **train_kw)
            image_dim = image.embed_dim
        else:
            # JAX's CNN builders take neither dropout nor remat
            image = build_cnn(image_tag, dict(image_arch or ()))
            image_dim = image.num_features
        bert = build_bert(text_tag, dict(text_arch or ()), **train_kw)
        self.image_encoder = _Wrapper(_Wrapper(image))
        self.text_encoder = _Wrapper(_Wrapper(bert))
        image.compute_dtype = bert.compute_dtype = compute_dtype
        if projection_name == "simple":
            proj = SimpleProjection
        elif projection_name == "complex":
            def proj(in_dim, dim):
                return ComplexProjection(in_dim, dim, projection_dropout)
        else:
            raise NotImplementedError(f"projection '{projection_name}'")
        self.image_projection = proj(image_dim, projection_dim)
        text_dim = bert.embeddings.word_embeddings.embedding_dim
        self.text_projection = proj(text_dim, projection_dim)
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
        number_dropout_sites(self)

    @property
    def image_tower(self) -> nn.Module:
        return self.image_encoder.model.model

    @property
    def vit(self) -> nn.Module:
        """The image tower, under the name most callers know it by."""
        return self.image_tower

    @property
    def bert(self) -> nn.Module:
        return self.text_encoder.model.model

    @property
    def patch_size(self) -> int:
        """The dense grid's step: the ViT's patch, a CNN's total stride (JAX
        ``tasks/seg_eval.image_patch_stride``)."""
        return self.image_tower.patch_size

    # -- temperature -----------------------------------------------------------
    def temperature(self) -> torch.Tensor:
        """Clamped temperature (parity: mml_loss.py:56)."""
        if self.temperature_name == "parameter":
            t = self.loss.temperature
        else:
            t = torch.tensor(self.temperature_init, dtype=torch.float32)
        return torch.clamp(t, 0.001, 0.5)

    # -- image tower -------------------------------------------------------------
    def forward_image_feature(self, images: torch.Tensor, key=None,
                              train_bn: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> ViT: CLS (B, D) for identity pooling, else the
        patch tokens (B, N, D); CNN: its map as (B, h·w, C) tokens.
        ``key``: the dropout key (None: no dropout); ``train_bn``: a CNN's
        BatchNorm on the batch's statistics."""
        if not self.is_vit:
            return self.forward_image_tokens(images, train_bn)
        tokens = self.image_tower(images, key)
        if self.pool_name == "identity":
            return tokens[:, 0]
        return tokens[:, 1:]

    def forward_image_tokens(self, images: torch.Tensor,
                             train_bn: bool = False) -> torch.Tensor:
        """ViT: the full (B, 1+N, D) sequence (seg eval needs CLS +
        patches); CNN: the (B, h·w, C) map tokens, no CLS."""
        if self.is_vit:
            return self.image_tower(images)
        fmap = self.image_tower(images, train_bn=train_bn)
        return fmap.reshape(fmap.shape[0], -1, fmap.shape[-1])

    def forward_image_project(self, image_features: torch.Tensor,
                              key=None) -> torch.Tensor:
        x = self.image_projection(image_features, key)
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
                             attention_mask: torch.Tensor,
                             key=None) -> torch.Tensor:
        return self.text_feature_of(self.bert(input_ids, attention_mask,
                                              key=key))

    def text_feature_of(self, hidden: torch.Tensor) -> torch.Tensor:
        """The text tower's last hidden state -> the feature the projection
        takes: the target token (identity pooling) or the tokens from it."""
        if self.pool_name == "identity":
            return hidden[:, self.target_token_idx]
        return hidden[:, self.target_token_idx:]

    def forward_text_project(self, text_features: torch.Tensor,
                             attention_mask: Optional[torch.Tensor],
                             key=None) -> torch.Tensor:
        x = self.text_projection(text_features, key)
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

    # -- joint ----------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                key=None, train_bn: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(image_emb, text_emb, temperature) of a batch with ``image``
        (B, H, W, 3) float, ``input_ids`` and ``attention_mask`` (B, T)
        (parity: JAX ``CLIPModel.__call__``, pipelines/clip.py:152-176).
        ``deterministic=False`` drops out with the dropout ``key``, or with
        one drawn from torch's default generator when none is given;
        ``train_bn``: a CNN tower's live BatchNorm."""
        if deterministic:
            key = None
        elif key is None:
            key = tuple(int(v) for v in torch.randint(0, 2**32, (2,)))
        mask = batch["attention_mask"]
        img = self.forward_image_feature(batch["image"], key, train_bn)
        txt = self.forward_text_feature(batch["input_ids"], mask, key)
        img = self.forward_image_project(img, key)
        txt = self.forward_text_project(txt, mask, key)
        return img, txt, self.temperature()


@PIPELINE.register(name="clip")
def build_clip_model(cfg, mesh=None) -> CLIPModel:
    """The CLIP model of a config tree (JAX ``build_clip_model``,
    ``simseg_tpu/models/clip.py:221-284``), float32 parameters, computing in
    bf16 when ``cfg.dist.bf16``.

    mesh: the world's ``parallel/mesh.DataMesh``; with model groups
    (``dist.tp_size``) the towers are made tensor-parallel, and with
    ``cfg.dist.sp`` the image tower's stream sequence-parallel, each rank
    keeping its shards (``parallel/sharding.shard_model``). ``dist.sp``
    on a mesh without model groups raises JAX's ``ValueError``."""
    model = _build(cfg)
    if mesh is not None:
        from simseg_tpu_torch.parallel.sharding import shard_model

        shard_model(model, mesh, tp=mesh.tp, sp=bool(cfg.dist.get("sp", False)))
    return model


def _build(cfg) -> CLIPModel:
    m = cfg.model

    def arch(enc_cfg):
        items = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in dict(enc_cfg.get("arch", {}) or {}).items()
            if v is not None))
        return items or None

    return CLIPModel(
        image_tag=m.image_encoder.tag,
        img_size=cfg.transforms.input_size,
        image_arch=arch(m.image_encoder),
        text_tag=m.text_encoder.tag,
        text_arch=arch(m.text_encoder),
        target_token_idx=m.text_encoder.target_token_idx,
        projection_name=m.projection.name,
        projection_dim=m.projection.dim,
        projection_dropout=m.projection.get("complex_projection", {}).get(
            "drop_out", 0.1),
        pool_name=m.pool.name,
        image_k=m.pool.loda.image_k,
        text_k=m.pool.loda.text_k,
        temperature_name=cfg.loss.temperature.name,
        temperature_init=cfg.loss.temperature.value,
        compute_dtype=torch.bfloat16 if cfg.dist.get("bf16", False) else None,
        remat=m.get("remat", False),
        remat_policy=m.get("remat_policy", "none"),
    )
