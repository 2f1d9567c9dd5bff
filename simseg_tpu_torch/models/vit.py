"""Vision Transformer returning the full token sequence (port of the dense
tower of ``simseg_tpu/models/vit.py``).

Parity: reference ``simseg/models/backbones/mml/vit_builder.py:8-27`` — a
timm ViT whose forward returns the complete (B, 1+N, D) sequence (CLS +
patches): patch-embed conv, learned CLS and position embeddings, pre-LN
blocks with fused-qkv attention, final LayerNorm, LN eps 1e-6. Module and
parameter names are timm's, so a reference state dict loads as it is.

Token merging (``tome_r``, ``tome_schedule``; ``ops/tome.py``), int8
post-training quantisation (``quant``; ``ops/quant.py``), dropout at JAX's
sites (``dropout``: after the position embeddings, the attention's output
projection, the MLP's GELU and its output; keyed, ``models/layers.py``) and
remat (``remat``, ``remat_policy``: each block under a non-reentrant
checkpoint, composing with the ToMe carry) are ported, and so are tensor
and sequence parallelism (``parallel/tp.py``: the blocks' linears sharded
over a model group, the residual stream sliced by tokens between blocks),
and so is the MoE option (``moe_experts``, ``moe_every``,
``moe_capacity``: block i's MLP is a top-1 MoE, ``ops/moe.py``, when
i % moe_every == moe_every - 1; JAX ``vit.py:202-208``). Compute runs in
``compute_dtype`` (None: the parameters' dtype), with float32 parameters
cast at use as flax does (``models/layers.py``): float32 master weights and
bf16 compute for training and for the int8 lanes, or
``model.to(torch.bfloat16)`` for float inference. GELU is exact in float32 and tanh-approximated otherwise.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.models.layers import (Dropout, LayerNorm, gelu,
                                            number_dropout_sites,
                                            parse_remat_policy, remat_call,
                                            whole_param)
from simseg_tpu_torch.ops.attention import multi_head_attention
from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed
from simseg_tpu_torch.ops.moe import MoEMlp
from simseg_tpu_torch.ops.quant import linear_cls
from simseg_tpu_torch.ops.tome import (bipartite_merge, size_bias, unmerge,
                                       update_gather_map)
from simseg_tpu_torch.parallel.collectives import reduce_from_group


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, quant: str = "none",
                 dropout: float = 0.0) -> None:
        super().__init__()
        linear = linear_cls(quant)
        self.fc1 = linear(dim, hidden_dim)
        self.fc2 = linear(hidden_dim, dim)
        self.drop1, self.drop2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(gelu(self.fc1(x)), key)), key)


class Attention(nn.Module):
    """Self-attention with one fused qkv projection (timm layout). The qkv
    and proj products quantise under ``quant``; the score and probability
    products stay in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, quant: str = "none",
                 dropout: float = 0.0) -> None:
        super().__init__()
        linear = linear_cls(quant)
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim)
        self.proj = linear(dim, dim)
        self.drop = Dropout(dropout)
        # tensor parallelism (parallel/sharding.py): this rank's heads of
        # ``tp`` model ranks in ``tp_group``
        self.tp, self.tp_group = 1, None

    def forward(self, x: torch.Tensor, attention_bias=None,
                return_keys: bool = False, key=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = self.drop(self.proj(multi_head_attention(q, k, v, self.num_heads,
                                                       attention_bias)), key)
        if return_keys:
            # the token-merging metric: the keys, mean over heads
            b, t, d = k.shape
            keys = k.reshape(b, t, self.num_heads,
                             d // self.num_heads).mean(dim=2)
            if self.tp > 1:
                # the mean over every rank's heads
                keys = reduce_from_group(keys, self.tp_group) / self.tp
            return out, keys
        return out


class Block(nn.Module):
    """Pre-LN block. In a token-merging tower (``tome_chain``) it takes and
    returns the carry ``(x, sizes, gather_map)`` and, after the first merge
    (``tome_first`` False), adds log(size) to the attention logits; with
    ``tome_r`` > 0 it merges that many token pairs between attention and
    MLP (JAX ``ViTBlock``). Before any merge the sizes are all ones, so no
    bias is passed and the block stays eligible for the attention kernels,
    whose gates all require ``attention_bias is None``. With ``moe_experts``
    > 0 its MLP is ``moe``, a top-1 MoE without dropout (JAX ``ViTBlock``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 tome_r: int = 0, tome_chain: bool = False,
                 tome_first: bool = False, quant: str = "none",
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity: float = 1.25) -> None:
        super().__init__()
        self.tome_r, self.tome_chain, self.tome_first = (tome_r, tome_chain,
                                                         tome_first)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, quant, dropout)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        if moe_experts > 0:
            self.moe = MoEMlp(dim, moe_experts, hidden, dim, moe_capacity)
        else:
            self.mlp = Mlp(dim, hidden, quant, dropout)

    def ffn(self, x, key=None):
        if hasattr(self, "moe"):
            return self.moe(x)
        return self.mlp(x, key)

    def forward(self, x, key=None):
        in_chain = self.tome_chain or self.tome_r > 0
        if not in_chain:
            x = x + self.attn(self.norm1(x), key=key)
            return x + self.ffn(self.norm2(x), key)
        if not (isinstance(x, tuple) and len(x) == 3):
            raise TypeError("Block(tome) takes the (x, sizes, gather_map) "
                            f"carry tuple, got {type(x).__name__}")
        x, sizes, gather_map = x
        bias = None if self.tome_first else size_bias(sizes, x.dtype)
        if self.tome_r > 0:
            attn_out, keys = self.attn(self.norm1(x), bias, return_keys=True,
                                       key=key)
            x, sizes, old2new = bipartite_merge(x + attn_out, sizes, keys,
                                                self.tome_r)
            gather_map = update_gather_map(gather_map, old2new)
        else:
            x = x + self.attn(self.norm1(x), bias, key=key)
        return x + self.ffn(self.norm2(x), key), sizes, gather_map


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
        weight = whole_param(self.proj, "weight").reshape(
            self.proj.out_channels, -1)
        return F.linear(patches, weight.to(images.dtype),
                        whole_param(self.proj, "bias").to(images.dtype))


class VisionTransformer(nn.Module):
    """ViT returning (B, 1+N, D); position embeddings sized for img_size,
    resampled for any other input size."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, tome_r: int = 0,
                 tome_schedule: Optional[Sequence[int]] = None,
                 quant: str = "none", dropout: float = 0.0,
                 remat: bool = False, remat_policy: str = "none",
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity: float = 1.25) -> None:
        super().__init__()
        self.img_size = img_size
        self.depth = depth
        self.tome_r = int(tome_r)
        self.tome_schedule = (None if tome_schedule is None
                              else tuple(int(r) for r in tome_schedule))
        self.quant = quant
        self.remat = bool(remat)
        self.remat_policy = parse_remat_policy(remat_policy)
        plan = self.tome_plan
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.num_patches, embed_dim))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio, tome_r=plan[i],
                   tome_chain=self.tome_on,
                   tome_first=self.tome_on and sum(plan[:i]) == 0,
                   quant=quant, dropout=dropout,
                   moe_experts=moe_experts if is_moe(i, moe_experts,
                                                     moe_every) else 0,
                   moe_capacity=moe_capacity)
             for i in range(depth)])
        self.pos_drop = Dropout(dropout)
        self.norm = LayerNorm(embed_dim, eps=1e-6)
        number_dropout_sites(self)
        # None: compute in the parameters' dtype
        self.compute_dtype: Optional[torch.dtype] = None
        # sequence parallelism (``parallel/tp.py:SeqParallel``, set by
        # ``parallel/sharding.shard_model``): the blocks run on token slices
        self.seq = None

    def forward(self, images: torch.Tensor, key=None) -> torch.Tensor:
        """images: (B, H, W, 3) NHWC float -> (B, 1+N, D) in the compute
        dtype; ``key``: the dropout key (None: no dropout)."""
        x = self.embed(images, key)
        if self.tome_on:
            b, t = x.shape[:2]
            carry = (x, torch.ones((b, t), device=x.device),
                     torch.arange(t, device=x.device).expand(b, t))
            for block in self.blocks:
                carry = self._block(block, carry, key)
            return unmerge(self.norm(carry[0]), carry[2])
        if self.seq is not None:
            x = self.seq.enter(x)
        for block in self.blocks:
            x = self._block(block, x, key)
        if self.seq is not None:
            x = self.seq.leave(x)
        return self.norm(x)

    def embed(self, images: torch.Tensor, key=None) -> torch.Tensor:
        """Patch embedding, CLS and position embeddings: (B, H, W, 3) ->
        (B, 1+N, D) in the compute dtype (JAX ``VisionTransformer.embed``,
        a stage of its own under pipeline parallelism)."""
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
        return self.pos_drop(torch.cat([cls, x], dim=1) + pos_embed, key)

    def _block(self, block, x, key):
        """One block, rematerialised under ``remat`` when autograd records
        (JAX ``nn.remat(ViTBlock)``, ``simseg_tpu/models/vit.py:295-297``)."""
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, self.remat_policy, x, key)
        return block(x, key)

    @property
    def tome_on(self) -> bool:
        return self.tome_r > 0 or bool(self.tome_schedule)

    @property
    def tome_plan(self) -> Tuple[int, ...]:
        """Merges per block: the schedule, else ``tome_r`` in every block
        (checked against the depth as the JAX tower does)."""
        if self.tome_schedule:
            sched = self.tome_schedule
            if len(sched) != self.depth:
                raise ValueError(f"tome_schedule has {len(sched)} entries for "
                                 f"a depth-{self.depth} tower")
            if any(r < 0 for r in sched):
                raise ValueError(f"tome_schedule entries must be >= 0: {sched}")
            return sched
        return (max(self.tome_r, 0),) * self.depth


def is_moe(i: int, experts: int, every: int) -> bool:
    """Whether block i of a tower with ``experts`` > 0 is an MoE block
    (JAX: every ``moe_every``-th, the last of each run)."""
    return experts > 0 and i % every == every - 1


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


def build_vit(tag: str, img_size: int, arch: Optional[dict] = None,
              **train_kw) -> VisionTransformer:
    """``train_kw``: ``dropout``, ``remat``, ``remat_policy``."""
    return VisionTransformer(img_size=img_size, **resolve_vit_config(tag, arch),
                             **train_kw)

