"""JAX-package parameters -> the port's state dict.

Takes the variables that ``simseg_tpu``'s flax ``CLIPModel`` or
``LinearProbModel`` initialises or trains (leaves as numpy arrays):
``params`` and, for a CNN tower, ``batch_stats``. Returns a state dict in
the reference's timm/HF names — the layout of
``simseg_tpu/checkpoint/torch_export.py:46-224`` (ViT, ResNet, ConvNeXt and
EfficientNet towers, BERT, simple/complex projections, temperature; BN
statistics as ``running_mean`` / ``running_var`` with a zero
``num_batches_tracked``, as ``flax_to_torch`` writes them) plus the linear
probe's ``classifier`` — which the port's models load with ``strict=True``.
Any other leaf or collection raises rather than being dropped.

``load_quant_state`` carries JAX's derived ``'quant'`` collection (the
cached int8 weights and calibrated activation ranges of ``QuantDense``
layers) into the port's ``QuantLinear`` buffers; ToMe and ``quant`` add no
parameter, so their models' parameters map as any other's.

Layout conversions (flax -> torch):
- Linear:    kernel (in, out)      -> weight (out, in)
- Conv2d:    kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
- Embedding: embedding             -> weight
- LayerNorm: scale / bias          -> weight / bias
- BatchNorm: scale / bias, mean / var -> weight / bias, running_mean / running_var

MoE layers (``ops/moe.py``) carry JAX's leaves: ``…/moe/router/kernel``
and ``bias`` as a linear's, ``…/moe/{w1,b1,w2,b2}`` as stored. The
reference's layout has no slot for them: ``reference_state_dict`` refuses
them under ``strict`` as JAX's ``flax_to_torch`` does.

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
    yield from _moe_rules(r"blocks_(\d+)", "blocks.{}")


def _moe_rules(flax_block, port_block):
    """An MoE layer (``ops/moe.py``): the router a linear, the experts'
    ``w1``/``b1``/``w2``/``b2`` as stored."""
    yield (rf"^{flax_block}/moe/router/kernel$",
           lambda m: port_block.format(m[1]) + ".moe.router.weight", _linear)
    yield (rf"^{flax_block}/moe/router/bias$",
           lambda m: port_block.format(m[1]) + ".moe.router.bias", None)
    yield (rf"^{flax_block}/moe/(w1|b1|w2|b2)$",
           lambda m: port_block.format(m[1]) + f".moe.{m[2]}", None)


# the CNN towers (JAX ``torch_bridge.py:163-319``): flax module path ->
# timm module path; a leaf maps by its name (``_LEAF``)
_CNN_MODULES = (
    (r"^(conv1|bn1|bn2|conv_stem|conv_head)$", lambda m: m[1]),
    (r"^layer(\d+)_(\d+)/(conv\d|bn\d)$", lambda m: f"layer{m[1]}.{m[2]}.{m[3]}"),
    (r"^layer(\d+)_(\d+)/downsample_(conv|bn)$",
     lambda m: f"layer{m[1]}.{m[2]}.downsample.{int(m[3] == 'bn')}"),
    (r"^stem_(conv|norm)$", lambda m: f"stem.{int(m[1] == 'norm')}"),
    (r"^downsample_(norm|conv)(\d+)$",
     lambda m: f"stages.{m[2]}.downsample.{int(m[1] == 'conv')}"),
    (r"^stage(\d+)_block(\d+)$", lambda m: f"stages.{m[1]}.blocks.{m[2]}"),
    (r"^stage(\d+)_block(\d+)/(conv_dw|norm)$",
     lambda m: f"stages.{m[1]}.blocks.{m[2]}.{m[3]}"),
    (r"^stage(\d+)_block(\d+)/(fc1|fc2)$",
     lambda m: f"stages.{m[1]}.blocks.{m[2]}.mlp.{m[3]}"),
    (r"^head_norm$", lambda m: "head.norm"),
    (r"^blocks_(\d+)_(\d+)/(conv_pw|conv_dw|conv_pwl|bn\d|se/conv_reduce|se/conv_expand)$",
     lambda m: f"blocks.{m[1]}.{m[2]}.{m[3].replace('/', '.')}"),
)
_LEAF = {"bias": "bias", "scale": "weight", "gamma": "gamma",
         "mean": "running_mean", "var": "running_var"}


def _kernel(x):
    """A conv kernel (kh, kw, I, O) or a dense kernel (in, out) in torch's
    layout."""
    x = np.asarray(x)
    return _conv(x) if x.ndim == 4 else _linear(x)


def _cnn_rules():
    for pattern, module_fn in _CNN_MODULES:
        body = pattern[1:-1]
        yield (rf"^{body}/kernel$", lambda m, f=module_fn: f"{f(m)}.weight",
               _kernel)
        yield (rf"^{body}/(bias|scale|gamma|mean|var)$",
               lambda m, f=module_fn: f"{f(m)}.{_LEAF[m[m.re.groups]]}", None)


def _image_rules():
    yield from _vit_rules()
    yield from _cnn_rules()


def _classifier_rules():
    yield r"^kernel$", lambda m: "weight", _linear
    yield r"^bias$", lambda m: "bias", None


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
    yield from _moe_rules(r"layer_(\d+)", "encoder.layer.{}")


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
    "image_encoder": (_IMG, _image_rules),
    "classifier": ("classifier.", _classifier_rules),
    "text_encoder": (_TXT, _bert_rules),
    "image_projection": ("image_projection.", _projection_rules),
    "text_projection": ("text_projection.", _projection_rules),
}


def _map_tree(tree, out: Dict[str, torch.Tensor], unmapped: list) -> None:
    for scope, subtree in tree.items():
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


def flax_params_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{'params': tree[, 'batch_stats': tree]}`` (or a bare params tree)
    of numpy arrays -> the port's state dict of float32 tensors (a zero
    int64 ``num_batches_tracked`` beside each BN's statistics)."""
    if "params" not in variables:
        variables = {"params": variables}
    extra = [k for k in variables if k not in ("params", "batch_stats")]
    if extra:
        raise ValueError(f"collections without a slot in the port: {extra}")
    params = dict(variables["params"])
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    if "temperature" in params:
        out["loss.temperature"] = torch.tensor(
            np.asarray(params.pop("temperature"), np.float32))
    _map_tree(params, out, unmapped)
    if variables.get("batch_stats"):
        _map_tree(variables["batch_stats"], out, unmapped)
        for key in [k for k in out if k.endswith(".running_mean")]:
            out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long))
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
        (r"^blocks\.(\d+)\.moe\.router\.(weight|bias)$",
         lambda m: f"blocks_{m[1]}/moe/router/{_DENSE_INV[m[2]]}"),
        (r"^blocks\.(\d+)\.moe\.(w1|b1|w2|b2)$",
         lambda m: f"blocks_{m[1]}/moe/{m[2]}"),
        # the CNN towers
        (r"^(conv1|conv_stem|conv_head)\.weight$", lambda m: f"{m[1]}/kernel"),
        (r"^(bn1|bn2)\.(weight|bias)$", lambda m: f"{m[1]}/{_LN_INV[m[2]]}"),
        (r"^layer(\d+)\.(\d+)\.(conv\d)\.weight$",
         lambda m: f"layer{m[1]}_{m[2]}/{m[3]}/kernel"),
        (r"^layer(\d+)\.(\d+)\.(bn\d)\.(weight|bias)$",
         lambda m: f"layer{m[1]}_{m[2]}/{m[3]}/{_LN_INV[m[4]]}"),
        (r"^layer(\d+)\.(\d+)\.downsample\.0\.weight$",
         lambda m: f"layer{m[1]}_{m[2]}/downsample_conv/kernel"),
        (r"^layer(\d+)\.(\d+)\.downsample\.1\.(weight|bias)$",
         lambda m: f"layer{m[1]}_{m[2]}/downsample_bn/{_LN_INV[m[3]]}"),
        (r"^stem\.0\.(weight|bias)$", lambda m: f"stem_conv/{_DENSE_INV[m[1]]}"),
        (r"^stem\.1\.(weight|bias)$", lambda m: f"stem_norm/{_LN_INV[m[1]]}"),
        (r"^stages\.(\d+)\.downsample\.0\.(weight|bias)$",
         lambda m: f"downsample_norm{m[1]}/{_LN_INV[m[2]]}"),
        (r"^stages\.(\d+)\.downsample\.1\.(weight|bias)$",
         lambda m: f"downsample_conv{m[1]}/{_DENSE_INV[m[2]]}"),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.gamma$",
         lambda m: f"stage{m[1]}_block{m[2]}/gamma"),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.norm\.(weight|bias)$",
         lambda m: f"stage{m[1]}_block{m[2]}/norm/{_LN_INV[m[3]]}"),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.(?:mlp\.)?(conv_dw|fc1|fc2)\.(weight|bias)$",
         lambda m: f"stage{m[1]}_block{m[2]}/{m[3]}/{_DENSE_INV[m[4]]}"),
        (r"^head\.norm\.(weight|bias)$", lambda m: f"head_norm/{_LN_INV[m[1]]}"),
        (r"^blocks\.(\d+)\.(\d+)\.(bn\d)\.(weight|bias)$",
         lambda m: f"blocks_{m[1]}_{m[2]}/{m[3]}/{_LN_INV[m[4]]}"),
        (r"^blocks\.(\d+)\.(\d+)\.(conv_pw|conv_dw|conv_pwl|se\.conv_reduce|"
         r"se\.conv_expand)\.(weight|bias)$",
         lambda m: f"blocks_{m[1]}_{m[2]}/{m[3].replace('.', '/')}/"
                   f"{_DENSE_INV[m[4]]}"),
    ),
    "classifier": ((r"^(weight|bias)$", lambda m: _DENSE_INV[m[1]]),),
    "text_encoder": (
        (r"^embeddings\.(word|position|token_type)_embeddings\.weight$",
         lambda m: f"{m[1]}_embeddings/embedding"),
        (r"^embeddings\.LayerNorm\.(weight|bias)$",
         lambda m: f"embeddings_norm/{_LN_INV[m[1]]}"),
        (rf"^encoder\.layer\.(\d+)\.({_HF_MODS})\.(weight|bias)$",
         _bert_layer_path),
        (r"^encoder\.layer\.(\d+)\.moe\.router\.(weight|bias)$",
         lambda m: f"layer_{m[1]}/moe/router/{_DENSE_INV[m[2]]}"),
        (r"^encoder\.layer\.(\d+)\.moe\.(w1|b1|w2|b2)$",
         lambda m: f"layer_{m[1]}/moe/{m[2]}"),
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
    """A parameter of the port's ``CLIPModel`` or ``LinearProbModel`` -> the
    path of the same
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


# -- the reference's layout -----------------------------------------------------

_NO_REFERENCE_SLOT = re.compile(r"\.moe\.")


def reference_state_dict(state: Dict[str, torch.Tensor], strict: bool = True):
    """``(state, report)``: the port's state dict as the reference's timm/HF
    layout holds it (JAX ``flax_to_torch``,
    ``simseg_tpu/checkpoint/torch_export.py:227-336``). The MoE leaves have
    no slot there: ``strict`` raises JAX's ``ValueError`` naming them by
    their JAX paths, else they are left out with a warning; ``report``
    lists the exported keys and the skipped paths."""
    import logging

    out = {k: v for k, v in state.items() if not _NO_REFERENCE_SLOT.search(k)}
    skipped = sorted(flax_param_path(k) for k in state if k not in out)
    if skipped:
        msg = (f"flax->torch: {len(skipped)} leaves have no slot in the "
               f"reference layout: {skipped}")
        if strict:
            raise ValueError(msg)
        logging.getLogger(__name__).warning(msg)
    return out, {"exported": sorted(out), "skipped": skipped}
