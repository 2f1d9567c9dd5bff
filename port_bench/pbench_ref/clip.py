"""The plain reference of the SimSeg CLIP model: a timm ViT image tower, a
HuggingFace BERT text tower, the 512-d simple projections and LoDA top-k
pooling, written from the published layer equations as functions of a
dict of tensors named as the reference checkpoints name them.

It imports nothing of the program. It computes in float32 (the caller
turns TF32 off: ``pbench_ref.precise``), with the exact erf GELU, a
softmax over float32 scores and LayerNorm over float32 statistics, as the
published models do. ``lowp`` (``pbench_ref.FP8Hybrid``) rounds the operands of every matrix product first, and
where it has an ``out``, each product's gradient on its way back: the
control that stands in for a lower precision than the configuration
states.

Sizes come from the configuration file's ``sizes``: ``image`` (patch, dim,
depth, heads, mlp, img_size), ``text`` (vocab, dim, depth, heads, inter,
max_pos, type_vocab) and ``proj_dim``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

IMG = "image_encoder.model.model."
TXT = "text_encoder.model.model."
Params = Dict[str, torch.Tensor]


def param_shapes(sizes: dict) -> Dict[str, tuple]:
    """name -> shape of every tensor of the model."""
    im, tx, p = sizes["image"], sizes["text"], sizes["proj_dim"]
    d, n0 = im["dim"], (im["img_size"] // im["patch"]) ** 2
    out = {IMG + "patch_embed.proj.weight": (d, 3, im["patch"], im["patch"]),
           IMG + "patch_embed.proj.bias": (d,),
           IMG + "cls_token": (1, 1, d), IMG + "pos_embed": (1, 1 + n0, d),
           IMG + "norm.weight": (d,), IMG + "norm.bias": (d,)}
    for i in range(im["depth"]):
        b = f"{IMG}blocks.{i}."
        out.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                    b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                    b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                    b + "mlp.fc1.weight": (im["mlp"], d),
                    b + "mlp.fc1.bias": (im["mlp"],),
                    b + "mlp.fc2.weight": (d, im["mlp"]), b + "mlp.fc2.bias": (d,)})
    t = tx["dim"]
    e = TXT + "embeddings."
    out.update({e + "word_embeddings.weight": (tx["vocab"], t),
                e + "position_embeddings.weight": (tx["max_pos"], t),
                e + "token_type_embeddings.weight": (tx["type_vocab"], t),
                e + "LayerNorm.weight": (t,), e + "LayerNorm.bias": (t,)})
    for i in range(tx["depth"]):
        b = f"{TXT}encoder.layer.{i}."
        for m in ("query", "key", "value"):
            out[f"{b}attention.self.{m}.weight"] = (t, t)
            out[f"{b}attention.self.{m}.bias"] = (t,)
        out.update({b + "attention.output.dense.weight": (t, t),
                    b + "attention.output.dense.bias": (t,),
                    b + "attention.output.LayerNorm.weight": (t,),
                    b + "attention.output.LayerNorm.bias": (t,),
                    b + "intermediate.dense.weight": (tx["inter"], t),
                    b + "intermediate.dense.bias": (tx["inter"],),
                    b + "output.dense.weight": (t, tx["inter"]),
                    b + "output.dense.bias": (t,),
                    b + "output.LayerNorm.weight": (t,),
                    b + "output.LayerNorm.bias": (t,)})
    out["image_projection.linear.weight"] = (p, d)
    out["text_projection.linear.weight"] = (p, t)
    out["loss.temperature"] = ()
    return out


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Ref:
    """The reference forward over ``params`` (float32 tensors, leaves that
    may require grad)."""

    def __init__(self, params: Params, sizes: dict,
                 lowp: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.p, self.s = params, sizes
        self.r = lowp or _identity
        # the rounding of a product's gradient on its way back, where the
        # control has one
        self.r_out = getattr(lowp, "out", _identity)

    # -- building blocks --------------------------------------------------
    def linear(self, x, w, b=None):
        y = self.r_out(torch.matmul(self.r(x), self.r(w).t()))
        return y if b is None else y + b

    def _attention(self, q, k, v, heads, bias=None):
        """q, k, v (B, T, D) -> (B, T, D): softmax(q k^T / sqrt(hd) + bias) v
        over float32 scores."""
        b, t, d = q.shape
        hd = d // heads
        qh, kh, vh = (x.reshape(b, t, heads, hd).transpose(1, 2) for x in (q, k, v))
        s = self.r_out(torch.matmul(self.r(qh), self.r(kh).transpose(-1, -2))) / math.sqrt(hd)
        if bias is not None:
            s = s + bias
        out = self.r_out(torch.matmul(self.r(torch.softmax(s, dim=-1)), self.r(vh)))
        return out.transpose(1, 2).reshape(b, t, d)

    # -- image tower ------------------------------------------------------
    def pos_embed(self, n_tokens: int) -> torch.Tensor:
        """The position embeddings on the grid of ``n_tokens`` patches:
        bicubic resampling of the configured grid where the input's differs
        (the recipe crops at 224 px a tower configured at 288)."""
        pe = self.p[IMG + "pos_embed"]
        n0 = pe.shape[1] - 1
        g0, g = int(round(math.sqrt(n0))), int(round(math.sqrt(n_tokens)))
        if g == g0:
            return pe
        grid = pe[:, 1:].reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(g, g), mode="bicubic",
                             align_corners=False)
        return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, g * g, -1)], 1)

    def image_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised images -> (B, 1 + N, D) after the final
        LayerNorm (timm ``forward_features``)."""
        im = self.s["image"]
        p, d = im["patch"], im["dim"]
        x = images.permute(0, 3, 1, 2)
        w = self.p[IMG + "patch_embed.proj.weight"]
        b_, _, hh, ww = x.shape
        gh, gw = hh // p, ww // p
        patches = (x.reshape(b_, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
                   .reshape(b_, gh * gw, 3 * p * p))
        x = self.linear(patches, w.reshape(d, -1), self.p[IMG + "patch_embed.proj.bias"])
        cls = self.p[IMG + "cls_token"].expand(b_, -1, -1)
        x = torch.cat([cls, x], 1) + self.pos_embed(gh * gw)
        for i in range(im["depth"]):
            q = f"{IMG}blocks.{i}."
            h = F.layer_norm(x, (d,), self.p[q + "norm1.weight"], self.p[q + "norm1.bias"], 1e-6)
            qkv = self.linear(h, self.p[q + "attn.qkv.weight"], self.p[q + "attn.qkv.bias"])
            a = self._attention(*qkv.chunk(3, dim=-1), im["heads"])
            x = x + self.linear(a, self.p[q + "attn.proj.weight"], self.p[q + "attn.proj.bias"])
            h = F.layer_norm(x, (d,), self.p[q + "norm2.weight"], self.p[q + "norm2.bias"], 1e-6)
            h = F.gelu(self.linear(h, self.p[q + "mlp.fc1.weight"], self.p[q + "mlp.fc1.bias"]))
            x = x + self.linear(h, self.p[q + "mlp.fc2.weight"], self.p[q + "mlp.fc2.bias"])
        return F.layer_norm(x, (d,), self.p[IMG + "norm.weight"], self.p[IMG + "norm.bias"], 1e-6)

    def image_embed(self, patches: torch.Tensor, k: int) -> torch.Tensor:
        """LoDA: the projection, the mean of each channel's k largest token
        values, L2 norm."""
        x = self.linear(patches, self.p["image_projection.linear.weight"])
        k = min(k, x.shape[1])
        return l2n(torch.topk(x.transpose(1, 2), k, dim=-1).values.mean(-1))

    # -- text tower -------------------------------------------------------
    def text_hidden(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, D): BERT's last hidden state, post-LN layers,
        padded keys masked out of the softmax."""
        tx = self.s["text"]
        d = tx["dim"]
        e = TXT + "embeddings."
        t = ids.shape[1]
        x = (self.p[e + "word_embeddings.weight"][ids]
             + self.p[e + "position_embeddings.weight"][:t][None]
             + self.p[e + "token_type_embeddings.weight"][0])
        x = F.layer_norm(x, (d,), self.p[e + "LayerNorm.weight"], self.p[e + "LayerNorm.bias"], 1e-12)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(x.dtype)
        for i in range(tx["depth"]):
            q = f"{TXT}encoder.layer.{i}."
            qs = [self.linear(x, self.p[f"{q}attention.self.{m}.weight"],
                              self.p[f"{q}attention.self.{m}.bias"])
                  for m in ("query", "key", "value")]
            a = self._attention(*qs, tx["heads"], bias)
            a = self.linear(a, self.p[q + "attention.output.dense.weight"],
                            self.p[q + "attention.output.dense.bias"])
            x = F.layer_norm(x + a, (d,), self.p[q + "attention.output.LayerNorm.weight"],
                             self.p[q + "attention.output.LayerNorm.bias"], 1e-12)
            h = F.gelu(self.linear(x, self.p[q + "intermediate.dense.weight"],
                                   self.p[q + "intermediate.dense.bias"]))
            h = self.linear(h, self.p[q + "output.dense.weight"], self.p[q + "output.dense.bias"])
            x = F.layer_norm(x + h, (d,), self.p[q + "output.LayerNorm.weight"],
                             self.p[q + "output.LayerNorm.bias"], 1e-12)
        return x

    def text_embed(self, ids: torch.Tensor, mask: torch.Tensor, k: int,
                   target: int = 0) -> torch.Tensor:
        """LoDA over the tokens from ``target`` on: the projection, each
        channel's mean of its k largest values among the real tokens (k at
        most the batch's shortest caption), L2 norm."""
        x = self.linear(self.text_hidden(ids, mask)[:, target:],
                        self.p["text_projection.linear.weight"])
        m = mask[:, target:] > 0
        k = int(min(k, int(m.sum(1).min())))
        x = x.masked_fill(~m[..., None], -1e4)
        return l2n(torch.topk(x.transpose(1, 2), k, dim=-1).values.mean(-1))

    def temperature(self) -> torch.Tensor:
        return torch.clamp(self.p["loss.temperature"], 0.001, 0.5)


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def normalise(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 (x / 255 - mean) / std."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s
