"""Vision Transformer returning the full token sequence (port of the dense
tower of ``simseg_tpu/models/vit.py``).

Parity: reference ``simseg/models/backbones/mml/vit_builder.py:8-27`` — a
timm ViT whose forward returns the complete (B, 1+N, D) sequence (CLS +
patches): patch-embed conv, learned CLS and position embeddings, pre-LN
blocks with fused-qkv attention, final LayerNorm, LN eps 1e-6. Module and
parameter names are timm's, so a reference state dict loads as it is.

The JAX tower's ToMe, int8, MoE and remat options are not ported. Compute
runs in ``compute_dtype`` (None: the parameters' dtype), with float32
parameters cast at use as flax does (``models/layers.py``): float32 master
weights and bf16 compute for training, or ``model.to(torch.bfloat16)`` for
inference. GELU is exact in float32 and tanh-approximated otherwise.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import LayerNorm, Linear, gelu
from simseg_tpu_torch.ops.attention import multi_head_attention
from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with one fused qkv projection (timm layout)."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(multi_head_attention(q, k, v, self.num_heads))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, N, D). The stride-p conv runs as unfold +
        matmul: a float32 matmul on the card is full float32, where cuDNN's
        convolution would default to TF32."""
        b, h, w, c = images.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (images.reshape(b, gh, p, gw, p, c)
                   .permute(0, 1, 3, 5, 2, 4)            # (B, gh, gw, C, p, p)
                   .reshape(b, gh * gw, c * p * p))
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(patches, weight.to(images.dtype),
                        self.proj.bias.to(images.dtype))


class VisionTransformer(nn.Module):
    """ViT returning (B, 1+N, D); position embeddings sized for img_size,
    resampled for any other input size."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.num_patches, embed_dim))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=1e-6)
        # None: compute in the parameters' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) NHWC float -> (B, 1+N, D) in the compute
        dtype."""
        dtype = self.compute_dtype or self.cls_token.dtype
        x = self.patch_embed(images.to(dtype))
        pos_embed = self.pos_embed
        if x.shape[1] != self.num_patches:
            # another input size (multi-scale inference, a training crop
            # smaller than input_size): resample the position grid
            # bicubically in f32 (JAX ``vit.py:323-334``)
            pos_embed = interpolate_pos_embed(pos_embed.float(), x.shape[1])
        pos_embed = pos_embed.to(dtype)
        cls = self.cls_token.to(dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + pos_embed
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


# timm tag -> architecture (vit_builder.py instantiates these through
# timm.create_model). Tags not listed are pattern-parsed below.
VIT_CONFIGS = {
    # tiny config for fast unit tests
    "vit_test": dict(patch_size=8, embed_dim=32, depth=2, num_heads=2),
}

# timm size-name -> (embed_dim, depth, num_heads); mlp_ratio is 4.0 for all
_VIT_SIZES = {
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "medium": (512, 12, 8),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
}

_TAG_RE = re.compile(
    r"^vit_(?P<size>tiny|small|medium|base|large|huge)"
    r"_patch(?P<patch>\d+)"
    r"_(?P<res>\d+)"
    r"(?P<rest>(_.*)?)$"
)


def _parse_timm_vit_tag(tag: str) -> Optional[dict]:
    """Standard timm ViT tag -> architecture. The trailing resolution is the
    pretraining one and suffixes such as ``_in21k`` select weights, so both
    are ignored."""
    m = _TAG_RE.match(tag.split(".")[0])
    if not m:
        return None
    dim, depth, heads = _VIT_SIZES[m.group("size")]
    return dict(patch_size=int(m.group("patch")), embed_dim=dim,
                depth=depth, num_heads=heads)


def resolve_vit_config(tag: str, arch: Optional[dict] = None) -> dict:
    """Tag table -> timm-pattern parse -> ``arch`` overrides."""
    spec = VIT_CONFIGS.get(tag)
    if spec is None:
        spec = _parse_timm_vit_tag(tag)
    spec = dict(spec) if spec else {}
    if arch:
        spec.update({k: v for k, v in dict(arch).items() if v is not None})
    required = ("patch_size", "embed_dim", "depth", "num_heads")
    missing = [k for k in required if k not in spec]
    if missing:
        raise KeyError(
            f"Unknown ViT tag '{tag}' (not in the table, not a standard timm "
            f"pattern) and arch is missing {missing}")
    return spec


def build_vit(tag: str, img_size: int,
              arch: Optional[dict] = None) -> VisionTransformer:
    return VisionTransformer(img_size=img_size, **resolve_vit_config(tag, arch))
