"""BERT text encoder returning the last hidden state (port of
``simseg_tpu/models/bert.py``).

Parity: reference ``simseg/models/backbones/mml/huggingface_builder.py:6-23``
(HF ``BertModel`` without pooler): word + position + token-type embeddings
and LayerNorm (eps 1e-12), post-LN layers with separate q/k/v projections,
GELU intermediate, additive padding mask. Module names are HF's, so a
reference state dict loads as it is. Compute runs in ``compute_dtype``
(None: the parameters' dtype), parameters cast at use as flax does
(``models/layers.py``). The MoE and int8 options and the
HuggingFace AutoConfig lookup are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from simseg_tpu_torch.models.layers import LayerNorm, Linear, gelu
from simseg_tpu_torch.ops.attention import multi_head_attention, padding_bias


class _SelfAttention(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)


class _DenseNorm(nn.Module):
    """HF's ``*Output`` modules: a Linear and a LayerNorm."""

    def __init__(self, in_dim: int, dim: int) -> None:
        super().__init__()
        self.dense = Linear(in_dim, dim)
        self.LayerNorm = LayerNorm(dim, eps=1e-12)


class _Attention(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.self = _SelfAttention(dim)
        self.output = _DenseNorm(dim, dim)


class _Intermediate(nn.Module):
    def __init__(self, dim: int, inter: int) -> None:
        super().__init__()
        self.dense = Linear(dim, inter)


class BertLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.attention = _Attention(dim)
        self.intermediate = _Intermediate(dim, intermediate_dim)
        self.output = _DenseNorm(intermediate_dim, dim)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        sa = self.attention.self
        attn = multi_head_attention(sa.query(x), sa.key(x), sa.value(x),
                                    self.num_heads, bias)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(attn))
        y = self.output.dense(gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, dim: int, max_position: int,
                 type_vocab_size: int) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_position, dim)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, dim)
        self.LayerNorm = LayerNorm(dim, eps=1e-12)


class _Encoder(nn.Module):
    def __init__(self, layers) -> None:
        super().__init__()
        self.layer = nn.ModuleList(layers)


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 intermediate_dim: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2) -> None:
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden_dim, max_position,
                                      type_vocab_size)
        self.encoder = _Encoder(
            [BertLayer(hidden_dim, num_heads, intermediate_dim)
             for _ in range(depth)])
        # None: compute in the parameters' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids: (B, T) int -> last hidden state (B, T, D) in the
        compute dtype."""
        emb = self.embeddings
        dtype = self.compute_dtype or emb.word_embeddings.weight.dtype
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        position_ids = torch.arange(t, device=input_ids.device)[None, :]
        x = emb.LayerNorm(emb.word_embeddings(input_ids).to(dtype)
                          + emb.position_embeddings(position_ids).to(dtype)
                          + emb.token_type_embeddings(token_type_ids).to(dtype))
        bias = None
        if attention_mask is not None:
            bias = padding_bias(attention_mask, torch.float32)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


BERT_CONFIGS = {
    # tiny config for fast unit tests
    "bert_test": dict(
        vocab_size=128, hidden_dim=32, depth=2, num_heads=2,
        intermediate_dim=64, max_position=64, type_vocab_size=2,
    ),
    "bert-base-uncased": dict(
        vocab_size=30522, hidden_dim=768, depth=12, num_heads=12,
        intermediate_dim=3072, max_position=512, type_vocab_size=2,
    ),
    "bert-base-cased": dict(
        vocab_size=28996, hidden_dim=768, depth=12, num_heads=12,
        intermediate_dim=3072, max_position=512, type_vocab_size=2,
    ),
    "bert-large-uncased": dict(
        vocab_size=30522, hidden_dim=1024, depth=24, num_heads=16,
        intermediate_dim=4096, max_position=512, type_vocab_size=2,
    ),
    "bert-large-cased": dict(
        vocab_size=28996, hidden_dim=1024, depth=24, num_heads=16,
        intermediate_dim=4096, max_position=512, type_vocab_size=2,
    ),
    "bert-base-multilingual-cased": dict(
        vocab_size=119547, hidden_dim=768, depth=12, num_heads=12,
        intermediate_dim=3072, max_position=512, type_vocab_size=2,
    ),
}


def resolve_bert_config(tag: str, arch: Optional[dict] = None) -> dict:
    """Tag table -> ``arch`` overrides."""
    spec = dict(BERT_CONFIGS.get(tag) or {})
    if arch:
        spec.update({k: v for k, v in dict(arch).items() if v is not None})
    required = ("vocab_size", "hidden_dim", "depth", "num_heads",
                "intermediate_dim")
    missing = [k for k in required if k not in spec]
    if missing:
        raise KeyError(f"Unknown BERT tag '{tag}' and arch is missing {missing}")
    spec.setdefault("max_position", 512)
    spec.setdefault("type_vocab_size", 2)
    return spec


def build_bert(tag: str, arch: Optional[dict] = None) -> BertEncoder:
    return BertEncoder(**resolve_bert_config(tag, arch))
