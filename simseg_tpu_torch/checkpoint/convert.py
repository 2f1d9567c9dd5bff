"""JAX-package parameters -> the port's state dict.

Takes the ``{'params': ...}`` tree that ``simseg_tpu``'s flax ``CLIPModel``
initialises or trains (leaves as numpy arrays) and returns a state dict in
the reference's timm/HF names — the layout of
``simseg_tpu/checkpoint/torch_export.py:46-224`` — which the port's
``CLIPModel`` loads with ``strict=True``. Only the towers the port has are
mapped (ViT, BERT, simple/complex projections, temperature); any other leaf
raises rather than being dropped.

``load_quant_state`` carries JAX's derived ``'quant'`` collection (the
cached int8 weights and calibrated activation ranges of ``QuantDense``
layers) into the port's ``QuantLinear`` buffers; ToMe and ``quant`` add no
parameter, so their models' parameters map as any other's.

Layout conversions (flax -> torch):
- Linear:    kernel (in, out)      -> weight (out, in)
- Conv2d:    kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
- Embedding: embedding             -> weight
- LayerNorm: scale / bias          -> weight / bias

``flax_param_path`` maps the other way for names only: a key of the port's
state dict -> the ``/``-joined path of the same leaf in the JAX package's
``{'params': ...}`` tree, so that rules written against the JAX names
(``optim.param_group_rules`` regexes, frozen patterns) select the same
tensors in both packages.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LN = {"scale": "weight", "bias": "bias"}

# the reference wraps both backbones two modules deep
_IMG = "image_encoder.model.model."
_TXT = "text_encoder.model.model."


def _linear(x):
    return np.asarray(x).T


def _conv(x):
    return np.transpose(np.asarray(x), (3, 2, 0, 1))


def _vit_rules():
    yield r"^cls_token$", lambda m: "cls_token", None
    yield r"^pos_embed$", lambda m: "pos_embed", None
    yield r"^patch_embed/kernel$", lambda m: "patch_embed.proj.weight", _conv
    yield r"^patch_embed/bias$", lambda m: "patch_embed.proj.bias", None
    yield r"^norm/(scale|bias)$", lambda m: f"norm.{_LN[m[1]]}", None
    yield (r"^blocks_(\d+)/(norm1|norm2)/(scale|bias)$",
           lambda m: f"blocks.{m[1]}.{m[2]}.{_LN[m[3]]}", None)
    yield (r"^blocks_(\d+)/attn/(qkv|proj)/kernel$",
           lambda m: f"blocks.{m[1]}.attn.{m[2]}.weight", _linear)
    yield (r"^blocks_(\d+)/attn/(qkv|proj)/bias$",
           lambda m: f"blocks.{m[1]}.attn.{m[2]}.bias", None)
    yield (r"^blocks_(\d+)/mlp/(fc1|fc2)/kernel$",
           lambda m: f"blocks.{m[1]}.mlp.{m[2]}.weight", _linear)
    yield (r"^blocks_(\d+)/mlp/(fc1|fc2)/bias$",
           lambda m: f"blocks.{m[1]}.mlp.{m[2]}.bias", None)


_BERT_LAYER = {
    "query": "attention.self.query",
    "key": "attention.self.key",
    "value": "attention.self.value",
    "attention_output": "attention.output.dense",
    "attention_norm": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense",
    "output": "output.dense",
    "output_norm": "output.LayerNorm",
}


def _bert_rules():
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        yield (rf"^{name}/embedding$",
               lambda m, n=name: f"embeddings.{n}.weight", None)
    yield (r"^embeddings_norm/(scale|bias)$",
           lambda m: f"embeddings.LayerNorm.{_LN[m[1]]}", None)
    mods = "|".join(_BERT_LAYER)
    yield (rf"^layer_(\d+)/({mods})/kernel$",
           lambda m: f"encoder.layer.{m[1]}.{_BERT_LAYER[m[2]]}.weight",
           _linear)
    yield (rf"^layer_(\d+)/({mods})/(scale|bias)$",
           lambda m: f"encoder.layer.{m[1]}.{_BERT_LAYER[m[2]]}."
                     f"{_LN[m[3]]}", None)


def _projection_rules():
    yield (r"^(linear|projection|fc)/kernel$",
           lambda m: f"{m[1]}.weight", _linear)
    yield r"^(projection|fc)/bias$", lambda m: f"{m[1]}.bias", None
    yield (r"^layer_norm/(scale|bias)$",
           lambda m: f"layer_norm.{_LN[m[1]]}", None)


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


_SCOPES = {
    "image_encoder": (_IMG, _vit_rules),
    "text_encoder": (_TXT, _bert_rules),
    "image_projection": ("image_projection.", _projection_rules),
    "text_projection": ("text_projection.", _projection_rules),
}


def flax_params_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or a bare params tree) of numpy arrays -> the
    port's ``CLIPModel`` state dict of float32 tensors."""
    params = variables["params"] if "params" in variables else variables
    extra = [k for k in variables if k != "params"] if "params" in variables else []
    if extra:
        raise ValueError(f"collections without a slot in the port: {extra}")
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for scope, subtree in params.items():
        if scope == "temperature":
            out["loss.temperature"] = torch.tensor(
                np.asarray(subtree, np.float32))
            continue
        if scope not in _SCOPES:
            unmapped.append(scope)
            continue
        prefix, rules = _SCOPES[scope]
        table = list(rules())
        for path, leaf in _leaves(subtree):
            joined = "/".join(path)
            for pattern, name_fn, convert in table:
                m = re.match(pattern, joined)
                if m:
                    arr = convert(leaf) if convert else np.asarray(leaf)
                    out[prefix + name_fn(m)] = torch.from_numpy(
                        np.array(arr, np.float32))
                    break
            else:
                unmapped.append(f"{scope}/{joined}")
    if unmapped:
        raise ValueError(f"params without a slot in the port: {unmapped}")
    return out


# -- the derived int8 state: JAX's 'quant' collection -> the port's buffers --

# QuantDense variable -> (QuantLinear buffer, conversion)
_QUANT_VARS = {"kernel_q": ("weight_q", lambda x: np.asarray(x, np.int8).T),
               "w_scale": ("w_scale", lambda x: np.asarray(x, np.float32)),
               "x_absmax": ("x_absmax", lambda x: np.asarray(x, np.float32))}


def flax_quant_to_buffers(quant) -> Dict[str, torch.Tensor]:
    """JAX's derived ``'quant'`` collection (``cache_quant_state``; leaves as
    numpy arrays) -> ``{port buffer name: tensor}``: per ``QuantDense``,
    ``kernel_q`` (K, N) int8 -> ``weight_q`` (N, K), ``w_scale`` (N,) and
    ``x_absmax`` (K,) float32. Layer names follow the parameters' rules."""
    out: Dict[str, torch.Tensor] = {}
    for scope, subtree in quant.items():
        if scope not in _SCOPES:
            raise ValueError(f"quant state without a slot in the port: {scope}")
        prefix, rules = _SCOPES[scope]
        table = list(rules())
        for path, leaf in _leaves(subtree):
            kernel = "/".join(path[:-1] + ("kernel",))
            for pattern, name_fn, _ in table:
                m = re.match(pattern, kernel)
                if m and path[-1] in _QUANT_VARS:
                    buffer, convert = _QUANT_VARS[path[-1]]
                    layer = (prefix + name_fn(m))[:-len("weight")]
                    out[layer + buffer] = torch.from_numpy(
                        np.array(convert(leaf)))
                    break
            else:
                raise ValueError("quant state without a slot in the port: "
                                 f"{scope}/{'/'.join(path)}")
    return out


def load_quant_state(model: torch.nn.Module, quant) -> None:
    """Sets the int8 buffers of ``model``'s ``QuantLinear`` layers from JAX's
    ``'quant'`` collection, on the layers' device; every quantised layer
    must be covered (the static ones with their ``x_absmax``)."""
    from simseg_tpu_torch.ops.quant import quant_layers

    layers = quant_layers(model)
    for name, value in flax_quant_to_buffers(quant).items():
        layer_name, buffer = name.rsplit(".", 1)
        layer = layers[layer_name]
        setattr(layer, buffer, value.to(layer.weight.device))
    missing = [n for n, layer in layers.items() if layer.weight_q is None
               or (layer.static_acts and layer.x_absmax is None)]
    if missing:
        raise ValueError(f"quantised layers without JAX quant state: {missing}")


# -- names only, the other way: port key -> JAX path ------------------------

_LN_INV = {"weight": "scale", "bias": "bias"}
_DENSE_INV = {"weight": "kernel", "bias": "bias"}
_HF_TO_BERT = {v: k for k, v in _BERT_LAYER.items()}
_HF_MODS = "|".join(re.escape(m) for m in _HF_TO_BERT)


def _bert_layer_path(m) -> str:
    kind = _LN_INV if m[2].endswith("LayerNorm") else _DENSE_INV
    return f"layer_{m[1]}/{_HF_TO_BERT[m[2]]}/{kind[m[3]]}"


_INVERSE = {
    "image_encoder": (
        (r"^(cls_token|pos_embed)$", lambda m: m[1]),
        (r"^patch_embed\.proj\.(weight|bias)$",
         lambda m: f"patch_embed/{_DENSE_INV[m[1]]}"),
        (r"^norm\.(weight|bias)$", lambda m: f"norm/{_LN_INV[m[1]]}"),
        (r"^blocks\.(\d+)\.(norm1|norm2)\.(weight|bias)$",
         lambda m: f"blocks_{m[1]}/{m[2]}/{_LN_INV[m[3]]}"),
        (r"^blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.(weight|bias)$",
         lambda m: f"blocks_{m[1]}/{m[2].replace('.', '/')}/{_DENSE_INV[m[3]]}"),
    ),
    "text_encoder": (
        (r"^embeddings\.(word|position|token_type)_embeddings\.weight$",
         lambda m: f"{m[1]}_embeddings/embedding"),
        (r"^embeddings\.LayerNorm\.(weight|bias)$",
         lambda m: f"embeddings_norm/{_LN_INV[m[1]]}"),
        (rf"^encoder\.layer\.(\d+)\.({_HF_MODS})\.(weight|bias)$",
         _bert_layer_path),
    ),
    "image_projection": (
        (r"^(linear|projection|fc)\.(weight|bias)$",
         lambda m: f"{m[1]}/{_DENSE_INV[m[2]]}"),
        (r"^layer_norm\.(weight|bias)$",
         lambda m: f"layer_norm/{_LN_INV[m[1]]}"),
    ),
}
_INVERSE["text_projection"] = _INVERSE["image_projection"]


def flax_param_path(name: str) -> str:
    """A key of the port's ``CLIPModel`` state dict -> the path of the same
    parameter in the JAX package's variables, e.g.
    ``image_encoder.model.model.blocks.0.attn.qkv.weight`` ->
    ``params/image_encoder/blocks_0/attn/qkv/kernel``."""
    if name == "loss.temperature":
        return "params/temperature"
    for scope, (prefix, _) in _SCOPES.items():
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        for pattern, path_fn in _INVERSE[scope]:
            m = re.match(pattern, rest)
            if m:
                return f"params/{scope}/{path_fn(m)}"
    raise ValueError(f"no JAX path for the port parameter '{name}'")
