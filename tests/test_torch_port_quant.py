"""PyTorch port (simseg_tpu_torch): int8 post-training quantisation
(``ops/quant.py``) and the towers' ``quant`` knob, held against the JAX
package on the same numpy inputs and the same weights.

Bars: int8 codes, int32 accumulators and the quantisers' scales are
bit-equal (the same float32 divisions and round-half-to-even on both
sides); dequantised outputs within 1e-6 relative (a float32 product of
three factors); a layer's calibrated buffers bit-equal; towers in float32
within 1e-4 with JAX's ``'quant'`` collection carried across
(``checkpoint/convert.py:load_quant_state``), the bar of
``tests/test_torch_port_models.py``.

The JAX towers run eagerly here, as ``cache_quant_state`` runs them: under
``jax.jit`` XLA's fusions round some LayerNorm and GELU outputs otherwise,
and an activation at a rounding boundary of the int8 grid then takes the
next code, which moves every output of its token by a quantisation step.
For the same reason each layer's calibration is held with its inputs shared
(``replayed_calibration_matches_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.models.bert import build_bert as jax_build_bert
from simseg_tpu.models.vit import build_vit as jax_build_vit
from simseg_tpu.ops import quant as jq
from simseg_tpu_torch.checkpoint.convert import (flax_params_to_state_dict,
                                                 flax_quant_to_buffers,
                                                 load_quant_state)
from simseg_tpu_torch.models.bert import build_bert
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.models.layers import Linear
from simseg_tpu_torch.models.vit import build_vit
from simseg_tpu_torch.ops import quant
from tests.test_models import tiny_clip

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ quantisers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rowwise_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 4.0).astype(np.float32)
    x[1, 2] = 0.0                                   # a zero token
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    jqx, js = jq.quantize_rowwise(jx)
    pqx, ps = quant.quantize_rowwise(px)
    assert pqx.dtype == torch.int8 and ps.shape == (3, 5, 1)
    np.testing.assert_array_equal(pqx.numpy(), _np(jqx))
    np.testing.assert_array_equal(ps.numpy(), _np(js))


def test_quantize_colwise_matches_jax():
    w = np.random.default_rng(1).normal(size=(48, 24)).astype(np.float32)
    w[:, 3] = 0.0                                   # a zero output channel
    jqw, js = jq.quantize_colwise(jnp.asarray(w))   # (K, N) kernel
    pqw, ps = quant.quantize_colwise(torch.from_numpy(w.T.copy()))  # (N, K)
    np.testing.assert_array_equal(pqw.numpy(), _np(jqw).T)
    np.testing.assert_array_equal(ps.numpy(), _np(js))


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int8_accumulators_match_jax(rows):
    """int8 x int8 -> int32, exact at any row count (16 rows or fewer are
    padded with zero rows for the card's ``_int_mm``)."""
    rng = np.random.default_rng(rows)
    xq = rng.integers(-127, 128, (rows, 64)).astype(np.int8)
    wq = rng.integers(-127, 128, (64, 24)).astype(np.int8)   # (K, N)
    want = _np(jq._int8_dot(jnp.asarray(xq), jnp.asarray(wq)))
    got = quant.int8_mm(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()))
    assert got.dtype == torch.int32 and got.shape == (rows, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, xq.astype(np.int64) @ wq.astype(np.int64))


def _x_w_b(seed, k=64, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 9, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


def test_int8_matmul_matches_jax():
    x, w, b = _x_w_b(2)
    jwq, jsw = jq.quantize_colwise(jnp.asarray(w))
    want = _np(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    pwq, psw = quant.quantize_colwise(torch.from_numpy(w.T.copy()))
    got = quant.int8_matmul(torch.from_numpy(x), pwq, psw, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    jxq, _ = jq.quantize_rowwise(jnp.asarray(x))
    pxq, _ = quant.quantize_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(quant.int8_mm(pxq, pwq).numpy(),
                                  _np(jq._int8_dot(jxq, jwq)))


def test_int8_matmul_static_matches_jax():
    x, w, b = _x_w_b(3)
    a = np.abs(x).reshape(-1, x.shape[-1]).max(0) * 0.8   # some entries clip
    jwq, jsw = jq.quantize_colwise(jnp.asarray(w * (a[:, None] / 127.0)))
    want = _np(jq.int8_matmul_static(jnp.asarray(x), jnp.asarray(127.0 / a),
                                     jwq, jsw, jnp.asarray(b)))
    pwq, psw = quant.quantize_colwise(torch.from_numpy(
        w.T * (a[None, :] / 127.0)))
    np.testing.assert_array_equal(pwq.numpy(), _np(jwq).T)
    got = quant.int8_matmul_static(torch.from_numpy(x),
                                   torch.from_numpy(127.0 / a), pwq, psw,
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- QuantLinear

def _dense_pair(static, seed=4):
    x, w, b = _x_w_b(seed)
    mod = jq.QuantDense(w.shape[1], static_acts=static)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    layer = quant.QuantLinear(w.shape[0], w.shape[1], static_acts=static)
    layer.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                           "bias": torch.from_numpy(b)})
    return x, mod, params, layer


def test_quant_linear_dynamic_matches_jax():
    x, mod, params, layer = _dense_pair(False)
    want = _np(mod.apply(params, jnp.asarray(x)))
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    # the cache is the same computation memoised
    quant.cache_quant_state(layer, [lambda: layer(torch.from_numpy(x[:1]))])
    assert layer.weight_q.dtype == torch.int8 and layer.x_absmax is None
    assert torch.equal(layer(torch.from_numpy(x)), got)


def test_quant_linear_static_calibrates_as_jax_over_three_batches():
    x, mod, params, layer = _dense_pair(True)
    batches = [x * s for s in (0.5, 2.0, 1.0)]    # the second sets the max
    vs = jq.cache_quant_state(mod, params,
                              [((jnp.asarray(xb),), {}) for xb in batches])
    quant.cache_quant_state(layer, [lambda xb=xb: layer(torch.from_numpy(xb))
                                    for xb in batches])
    q = vs["quant"]
    np.testing.assert_array_equal(layer.x_absmax.numpy(), _np(q["x_absmax"]))
    np.testing.assert_array_equal(layer.weight_q.numpy(), _np(q["kernel_q"]).T)
    np.testing.assert_array_equal(layer.w_scale.numpy(), _np(q["w_scale"]))
    want = _np(mod.apply(vs, jnp.asarray(x)))
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quant_linear_keeps_the_linear_state_dict():
    layer = quant.QuantLinear(16, 8, static_acts=True)
    quant.cache_quant_state(layer, [lambda: layer(torch.randn(3, 16))])
    assert set(layer.state_dict()) == set(Linear(16, 8).state_dict())
    assert layer.weight_q is not None and layer.x_absmax is not None


def test_quant_errors():
    with pytest.raises(NotImplementedError, match="int8_static"):
        quant.linear_cls("int4")
    with pytest.raises(NotImplementedError, match="int8_static"):
        jq.dense_cls("int4")
    layer = quant.QuantLinear(16, 8, static_acts=True)
    with pytest.raises(RuntimeError, match="calibration"):
        layer(torch.randn(2, 16))
    dynamic = quant.QuantLinear(16, 8).to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32 master weights"):
        dynamic(torch.randn(2, 16, dtype=torch.bfloat16))
    vit = build_vit("vit_test", 32, dict(quant="int8_static"))
    with pytest.raises(RuntimeError, match="calibration"):
        vit(torch.zeros(1, 32, 32, 3))
    assert quant.linear_cls("none") is Linear and quant.linear_cls("") is Linear


# ----------------------------------------------------------------- towers

def _collection(tree):
    return jax.tree.map(np.asarray, tree)


def _load_tower(port, scope, quant_tree):
    """``load_quant_state`` for a bare tower: the converter's names less
    the CLIP model's prefix."""
    prefix = f"{scope}.model.model."
    layers = quant.quant_layers(port)
    for key, value in flax_quant_to_buffers({scope: quant_tree}).items():
        name, buffer = key[len(prefix):].rsplit(".", 1)
        setattr(layers[name], buffer, value)
    assert all(layer.weight_q is not None for layer in layers.values())


def _vit_pair(arch, size=32, tag="vit_test"):
    flax_vit = jax_build_vit(tag, size, arch=arch)
    params = _collection(jax.jit(flax_vit.init)(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    prefix = "image_encoder.model.model."
    state = {k[len(prefix):]: v for k, v in flax_params_to_state_dict(
        {"params": {"image_encoder": params["params"]}}).items()}
    port = build_vit(tag, size, arch).eval()
    port.load_state_dict(state, strict=True)
    return flax_vit, params, port


def _images(seed, n, size=32):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(
        np.float32)


VIT_CASES = {
    "int8": dict(quant="int8"),
    "int8_static": dict(quant="int8_static"),
    "tome_int8": dict(quant="int8", tome_r=2),
    "tome_int8_static": dict(quant="int8_static", tome_r=2),
    "vit_s_int8_static": dict(quant="int8_static", depth=2),
}


@pytest.mark.parametrize("name", list(VIT_CASES))
def test_vit_quant_matches_flax_with_the_collection_carried(name):
    arch = VIT_CASES[name]
    tag, size = (("vit_small_patch16_224", 64) if name.startswith("vit_s")
                 else ("vit_test", 32))
    flax_vit, params, port = _vit_pair(arch, size, tag)
    calib = [_images(s, 2, size) for s in (10, 11, 12)]
    vs = _collection(jq.cache_quant_state(
        flax_vit, params, [((jnp.asarray(c),), {}) for c in calib]))
    _load_tower(port, "image_encoder", vs["quant"])
    images = _images(13, 2, size)
    want = _np(flax_vit.apply(vs, jnp.asarray(images)))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cache_quant_state_rebuilds_after_new_weights():
    port = build_vit("vit_test", 32, dict(quant="int8"))
    imgs = torch.from_numpy(_images(5, 1))
    quant.cache_quant_state(port, [lambda: port(imgs)])
    stale = port.blocks[0].attn.qkv.weight_q.clone()
    with torch.no_grad():
        port.blocks[0].attn.qkv.weight.mul_(-1.0)
    quant.cache_quant_state(port, [lambda: port(imgs)])
    assert torch.equal(port.blocks[0].attn.qkv.weight_q, -stale)


def _bert_pair(arch):
    flax_bert = jax_build_bert("bert_test", arch=arch)
    ids = jnp.zeros((1, 10), jnp.int32)
    params = _collection(jax.jit(flax_bert.init)(jax.random.key(0), ids,
                                                 jnp.ones_like(ids)))
    prefix = "text_encoder.model.model."
    state = {k[len(prefix):]: v for k, v in flax_params_to_state_dict(
        {"params": {"text_encoder": params["params"]}}).items()}
    port = build_bert("bert_test", arch).eval()
    port.load_state_dict(state, strict=True)
    return flax_bert, params, port


def _text(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_bert_quant_matches_flax_with_the_collection_carried(mode):
    flax_bert, params, port = _bert_pair(dict(quant=mode))
    calib = [_text(s) for s in (30, 31, 32)]
    vs = _collection(jq.cache_quant_state(
        flax_bert, params,
        [((jnp.asarray(i), jnp.asarray(m)), {}) for i, m in calib]))
    _load_tower(port, "text_encoder", vs["quant"])
    ids, mask = _text(33)
    want = _np(flax_bert.apply(vs, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def replayed_calibration_matches_jax(port, run, passes):
    """Calls ``run()``, which must calibrate ``port`` (``cache_quant_state``
    directly or through ``evaluate_benchmark``), recording every quantised
    layer's inputs in each of its ``passes`` calibration passes; then runs
    JAX's ``cache_quant_state`` on one ``QuantDense`` per layer with those
    same inputs: the buffers must be JAX's collection bit for bit (codes,
    absmax and scales). The inputs are shared because each package's own
    tower computes its activations with float32 ulps of difference
    (LayerNorms summed in another order), and an activation or folded
    weight at a half step of the int8 grid then takes the neighbouring code;
    that the towers compute what JAX's compute from the
    same state is held by the forward tests with the collection carried.
    Returns what ``run`` returned."""
    layers = quant.quant_layers(port)
    seen = {name: [] for name in layers}

    def record(mod, args, name):
        if mod.calibrating:
            seen[name].append(args[0].numpy().copy())

    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, name=name: record(mod, args, name))
        for name, layer in layers.items()]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    assert layers and all(len(v) == passes for v in seen.values())
    for name, layer in layers.items():
        mod = jq.QuantDense(layer.out_features, static_acts=layer.static_acts)
        params = {"params": {
            "kernel": jnp.asarray(layer.weight.detach().numpy().T),
            "bias": jnp.asarray(layer.bias.detach().numpy())}}
        q = jq.cache_quant_state(
            mod, params, [((jnp.asarray(x),), {}) for x in seen[name]])["quant"]
        np.testing.assert_array_equal(layer.weight_q.numpy(),
                                      _np(q["kernel_q"]).T, err_msg=name)
        np.testing.assert_array_equal(layer.w_scale.numpy(), _np(q["w_scale"]),
                                      err_msg=name)
        if layer.static_acts:
            np.testing.assert_array_equal(layer.x_absmax.numpy(),
                                          _np(q["x_absmax"]), err_msg=name)
    return out


CALIB_TOWERS = {
    "vit_int8_static": ("vit_test", 32, dict(quant="int8_static")),
    "vit_s_int8_static": ("vit_small_patch16_224", 64,
                          dict(quant="int8_static", depth=2)),
    "vit_tome_int8_static": ("vit_test", 32,
                             dict(quant="int8_static", tome_r=2)),
    "vit_int8": ("vit_test", 32, dict(quant="int8")),
}


@pytest.mark.parametrize("name", list(CALIB_TOWERS))
def test_vit_calibration_over_three_batches_matches_jax(name):
    tag, size, arch = CALIB_TOWERS[name]
    port = build_vit(tag, size, arch).eval()
    calib = [torch.from_numpy(_images(s, 2, size)) for s in (20, 21, 22)]
    replayed_calibration_matches_jax(
        port, lambda: quant.cache_quant_state(port, [lambda c=c: port(c)
                                                     for c in calib]), 3)


def test_bert_calibration_over_three_batches_matches_jax():
    """Padded batches, as the prompt bank's: the absmax takes the padded
    positions' activations too, on both sides."""
    port = build_bert("bert_test", dict(quant="int8_static")).eval()
    calib = [_text(s) for s in (50, 51, 52)]
    calls = [lambda i=i, m=m: port(torch.from_numpy(i).long(),
                                   torch.from_numpy(m)) for i, m in calib]
    replayed_calibration_matches_jax(
        port, lambda: quant.cache_quant_state(port, calls), 3)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_bert_quant_padding_isolation(mode):
    """Other padding content, the same real tokens: the real positions'
    hidden states are bit-equal (no activation scale spans tokens)."""
    port = build_bert("bert_test", dict(quant=mode)).eval()
    rng = np.random.default_rng(9)
    ids_a = rng.integers(1, 128, (1, 10))
    ids_b = ids_a.copy()
    ids_b[0, 6:] = rng.integers(1, 128, 4)
    mask = torch.tensor([[1] * 6 + [0] * 4])
    a, b = torch.from_numpy(ids_a), torch.from_numpy(ids_b)
    quant.cache_quant_state(port, [lambda: port(a, mask)])
    with torch.no_grad():
        assert torch.equal(port(a, mask)[:, :6], port(b, mask)[:, :6])


def test_clip_quant_matches_flax():
    """Both towers int8_static, the image tower also merging tokens; the
    whole model against flax with the collection carried across."""
    arch = dict(image_arch=(("quant", "int8_static"), ("tome_r", 2)),
                text_arch=(("quant", "int8_static"),))
    flax_model = tiny_clip(**arch)
    seq = 12
    rng = np.random.default_rng(40)
    batch = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 100, (2, seq)).astype(np.int32),
             "attention_mask": np.ones((2, seq), np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _collection(jax.jit(flax_model.init)(jax.random.key(0), jbatch))
    vs = _collection(jq.cache_quant_state(flax_model, params, [((jbatch,), {})]))
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3, **arch).eval()
    port.load_state_dict(flax_params_to_state_dict(
        {"params": vs["params"]}), strict=True)
    load_quant_state(port, vs["quant"])
    want = flax_model.apply(vs, jbatch)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_quant_and_tome_add_no_parameter_and_convert_one_to_one():
    """The parameters of a ToMe + int8 model map 1:1 as the float model's:
    the same keys and values through the converter, and the buffers stay
    out of the state dict."""
    from simseg_tpu.checkpoint.torch_export import flax_to_torch

    arch = dict(image_arch=(("quant", "int8"), ("tome_r", 2)),
                text_arch=(("quant", "int8_static"),))
    flax_model = tiny_clip(**arch)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, 8), jnp.int32),
             "attention_mask": jnp.ones((1, 8), jnp.int32)}
    params = _collection(jax.jit(flax_model.init)(jax.random.key(0), dummy))
    assert "quant" not in params
    ours = flax_params_to_state_dict(params)
    ref, _ = flax_to_torch(params)
    assert sorted(ours) == sorted(ref)
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3, **arch)
    plain = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16, image_k=3)
    assert list(port.state_dict()) == list(plain.state_dict())
    port.load_state_dict(ours, strict=True)


def test_load_quant_state_refuses_what_does_not_fit():
    flax_vit, params, port = _vit_pair(dict(quant="int8_static"))
    vs = _collection(jq.cache_quant_state(
        flax_vit, params, [((jnp.asarray(_images(1, 1)),), {})]))
    partial = {"image_encoder": {k: v for k, v in vs["quant"].items()
                                 if k != "blocks_1"}}
    with pytest.raises(ValueError, match="without JAX quant state"):
        load_quant_state(CLIPModel(image_tag="vit_test", img_size=32,
                                   text_tag="bert_test", projection_dim=16,
                                   image_arch=(("quant", "int8_static"),)),
                         partial)
    with pytest.raises(ValueError, match="without a slot"):
        flax_quant_to_buffers({"image_encoder": {"head": {"kernel_q": np.ones(2)}}})


def test_runner_refuses_quant_in_training():
    from simseg_tpu_torch import config
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.tasks.clip import config as clip_config

    for enc in ("image_encoder", "text_encoder"):
        cfg = config.update_cfg(
            clip_config.task_cfg_init_fn, None,
            ["model.image_encoder.tag=vit_test",
             "model.text_encoder.tag=bert_test", "transforms.input_size=32",
             "model.projection.dim=16", "model.max_length=8",
             "dist.bf16=false", f"model.{enc}.arch={{'quant': 'int8'}}"],
            preprocess_fn=clip_config.update_clip_config,
            target=config.new_base_cfg())
        with pytest.raises(NotImplementedError, match="inference-only"):
            CLIPRunner(cfg, build_clip_model(cfg), {"train": []}, device="cpu")
