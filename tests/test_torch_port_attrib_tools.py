"""PyTorch port (simseg_tpu_torch): the attribution tools
(``simseg_tpu_torch/tools/{bench_common,benchmark_decode_attrib,
benchmark_components,benchmark_train_attrib}.py``) against JAX's
``tools/`` counterparts on the CPU.

- ``tower_flops`` equal to JAX's on a grid of arguments;
- the decode tool's variants are JAX's lanes (names and keywords read from
  JAX's tool), and each variant's pred / best_w through the port's decode
  equals JAX's ``make_seg_decode_fn`` at B = 1, 48 px (stride 12 needs a
  size it divides, which 64 is not): pred on >= 99.9% of pixels, best_w
  within 1e-5 where pred agrees (both run the plain chain in float32);
- each micro-lane's body in float32 against the same body written from
  JAX's ``simseg_tpu.ops.crf`` helpers, relative 1e-4 of the largest
  entry (float32 sums in another order; the bilateral lane chains three
  unnormalised products);
- the train-attribution phases (loss, the three gradient norms, one AdamW
  update's parameter and moment norms) against JAX on a 2-block, 64-wide
  CLIP, weights carried across by ``checkpoint/convert.py``, relative 1e-4;
- the components tool's lanes and its ``--only`` filter against JAX's, and
  its ``main`` over every lane at a toy size;
- every tool refuses to run without a card unless given ``--device cpu``
  and imports neither ``jax``, ``simseg_tpu`` nor the repo's ``tools``.
"""

import ast
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.train_step import clip_loss_fn as jax_clip_loss_fn
from simseg_tpu.models.clip import CLIPModel as JaxCLIP
from simseg_tpu.ops import crf as jcrf
from simseg_tpu.ops.morphology import nearest_upsample as jax_nearest_upsample
from simseg_tpu.ops.seg_decode import make_seg_decode_fn as jax_decode_fn
from simseg_tpu.utils.collections import AttrDict, OpenDict
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
from simseg_tpu_torch.tools import bench_common
from simseg_tpu_torch.tools import benchmark_components as components
from simseg_tpu_torch.tools import benchmark_decode_attrib as decode_attrib
from simseg_tpu_torch.tools import benchmark_train_attrib as train_attrib
from tools.bench_common import tower_flops as jax_tower_flops

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("benchmark_decode_attrib", "benchmark_components",
         "benchmark_train_attrib", "benchmark_input_pipeline",
         "benchmark_train_pipeline")


def _jax_tool_source(name):
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return f.read()


@pytest.mark.parametrize("t,d,depth,extra", [
    (325, 768, 12, 325 * 768 * (3 * 256) + 325 * 768 * 512),
    (25, 768, 12, 25 * 768 * 512), (1297, 1024, 24, 0.0), (1, 1, 1, 0.0),
    (197, 384, 6, 1.5)])
def test_tower_flops_is_jax(t, d, depth, extra):
    assert bench_common.tower_flops(t, d, depth, extra) == \
        jax_tower_flops(t, d, depth, extra)


def _jax_decode_variants():
    """(name, keywords) of JAX's ``time_decode`` calls, the stride sweep's
    f-string expanded over its loop."""
    tree = ast.parse(_jax_tool_source("benchmark_decode_attrib"))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple) \
                and getattr(node.target, "id", None) == "s":
            for s in ast.literal_eval(node.iter):
                out.append((f"decode_stride{s}", {"bilateral_stride": s}))
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "time_decode" and isinstance(node.args[0], ast.Constant)):
            out.append((node.args[0].value,
                        {k.arg: ast.literal_eval(k.value) for k in node.keywords}))
    return out


def test_decode_variants_are_jax_lanes():
    assert list(decode_attrib.DECODE_VARIANTS) == _jax_decode_variants()
    src = _jax_tool_source("benchmark_decode_attrib")
    micro = re.findall(r'lane\("(mf_[a-z0-9_]+)"', src)
    assert [n for n, _ in decode_attrib.MICRO_LANES] == micro
    assert [f"crf_only_{j}" for j, _ in decode_attrib.CRF_ONLY] == [
        f"crf_only_{i}" for i in ast.literal_eval(
            re.search(r'for impl in (\([^)]*\))', src).group(1))]


DECODE_SIZE = 48


@pytest.fixture(scope="module")
def decode_case():
    dense, pooled, tb, raw, probs = decode_attrib.decode_inputs(
        1, "cpu", size=DECODE_SIZE)
    return dense, pooled, tb, raw


@pytest.mark.parametrize("name,kw", decode_attrib.DECODE_VARIANTS,
                         ids=[n for n, _ in decode_attrib.DECODE_VARIANTS])
def test_decode_variant_matches_jax(decode_case, name, kw):
    args = decode_case
    pred, best_w = make_seg_decode_fn(decode_attrib.CLASSES, DECODE_SIZE, 16,
                                      10, 5, **kw)(*args)
    jpred, jbest = jax.jit(jax_decode_fn(decode_attrib.CLASSES, DECODE_SIZE, 16,
                                         10, 5, **kw))(
        *(jnp.asarray(a.numpy()) for a in args))
    jpred, jbest = np.asarray(jpred), np.asarray(jbest)
    same = pred.numpy() == jpred
    assert same.mean() >= 0.999, name
    np.testing.assert_allclose(best_w.numpy()[same], jbest[same], rtol=0,
                               atol=1e-5, err_msg=name)


def _jax_micro_bodies(d, taps, rgb_small, kmat, stride):
    """JAX's micro-lane bodies (``tools/benchmark_decode_attrib.py:
    135-194``) on JAX's helpers."""
    h = d.shape[-1]
    bsz, k = d.shape[:2]
    band = jcrf._band_matrix(h, taps)

    def gauss(d):
        for _ in range(3):
            d = jcrf._sep_blur(d, taps)
        return d

    def blur_w(d):
        n = d.reshape(-1, h, h)
        for _ in range(3):
            n = jnp.einsum("nhw,wv->nhv", n, band,
                           preferred_element_type=jnp.float32).astype(d.dtype)
        return n

    def blur_h(d):
        n = d.reshape(-1, h, h)
        for _ in range(3):
            n = jnp.einsum("nhv,hu->nuv", n, band,
                           preferred_element_type=jnp.float32).astype(d.dtype)
        return n

    def bilateral(d):
        for _ in range(3):
            small = jcrf._box_downsample(d, stride).reshape(bsz, k, -1)
            m = jnp.einsum("bcn,bmn->bcm", small, kmat,
                           preferred_element_type=jnp.float32).astype(d.dtype)
            d = jax_nearest_upsample(m.reshape(bsz, k, h // stride,
                                               h // stride), stride)
        return d

    def kmat_build(_):
        return jax.vmap(lambda x: jcrf._bilateral_kernel_matrix(
            x, 40.0, 13.0, stride))(rgb_small)

    def tanh(d):
        for _ in range(3):
            d = jnp.tanh((d + d) * 0.5)
        return d

    return {"mf_gauss_blur_x3": gauss, "mf_blur_w_only_x3": blur_w,
            "mf_blur_h_only_x3": blur_h, "mf_bilateral_apply_x3": bilateral,
            "mf_kmat_build": kmat_build, "mf_tanh_combine_x3": tanh}


@pytest.mark.parametrize("name,body", decode_attrib.MICRO_LANES,
                         ids=[n for n, _ in decode_attrib.MICRO_LANES])
def test_micro_lane_matches_jax_body(name, body):
    _, _, _, raw, probs = decode_attrib.decode_inputs(1, "cpu",
                                                      size=DECODE_SIZE)
    x = decode_attrib.micro_inputs(probs, raw, dtype=torch.float32)
    raw_j = jnp.asarray(raw.numpy())
    rgb_small = jnp.moveaxis(jcrf._box_downsample(
        jnp.moveaxis(raw_j.astype(jnp.float32), -1, 1), 8), 1, -1)
    kmat = jax.vmap(lambda r: jcrf._bilateral_kernel_matrix(
        r, 40.0, 13.0, 8))(rgb_small)
    taps = jnp.asarray(jcrf._gaussian_taps(3.0)).astype(jnp.float32)
    d = jnp.asarray(probs.numpy()) * 2.0 - 1.0
    want = np.asarray(_jax_micro_bodies(d, taps, rgb_small, kmat, 8)[name](d))
    got = body(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


# -- train attribution: a 2-block, 64-wide CLIP --------------------------------

TRAIN_FIELDS = dict(
    image_tag="vit_test", img_size=32, text_tag="bert_test",
    image_arch=(("embed_dim", 64), ("num_heads", 2)),
    text_arch=(("hidden_dim", 64), ("intermediate_dim", 128)),
    projection_name="simple", projection_dim=16, pool_name="loda", image_k=3,
    text_k=1, temperature_name="parameter", temperature_init=0.02)
SEQ = 8


def _jax_adamw(params):
    cfg = AttrDict()
    cfg.optim = AttrDict()
    cfg.optim.name = "torch.optim.AdamW"
    cfg.optim.param = OpenDict(**components.ADAMW)
    cfg.optim.param_group_rules = OpenDict()
    cfg.optim.grad_clip = OpenDict()
    return jax_build_optimizer(cfg, params)


def _seeded_params(flax_model, dummy):
    """The model's parameter tree (shapes from ``jax.eval_shape``: no init
    to compile) drawn from a seeded generator: LayerNorm scales near 1,
    the temperature at its init."""
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "temperature":
            return np.full(leaf.shape, 0.02, leaf.dtype)
        x = rng.normal(0.0, 0.05, leaf.shape).astype(leaf.dtype)
        return x + 1.0 if name == "scale" else x

    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), dummy)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_train_attribution_phases_match_jax():
    rng = np.random.default_rng(7)
    batch = {"image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             "input_ids": rng.integers(1, 128, (4, SEQ)).astype(np.int32),
             "attention_mask": np.ones((4, SEQ), np.int32)}
    batch["attention_mask"][1, 5:] = 0
    flax_model = JaxCLIP(**TRAIN_FIELDS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _seeded_params(flax_model, {k: v[:1] for k, v in jb.items()})
    port = CLIPModel(**TRAIN_FIELDS)
    port.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    assert port.vit.embed_dim == 64 and len(port.vit.blocks) == 2
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    opt = components.adamw(port)
    fns = train_attrib.phase_fns(port, tb, opt)

    def loss(p):
        return jax_clip_loss_fn(flax_model, p, jb, None)[0]

    def tower(p, which):
        if which == "image":
            t = flax_model.apply(p, jb["image"],
                                 method=lambda m, im: m.forward_image_tokens(im))
            e = flax_model.apply(p, t[:, 1:],
                                 method=lambda m, tt: m.forward_image_project(tt))
        else:
            h = flax_model.apply(
                p, jb["input_ids"], jb["attention_mask"],
                method=lambda m, a, c: m.forward_text_feature(a, c))
            e = flax_model.apply(
                p, h, jb["attention_mask"],
                method=lambda m, t, c: m.forward_text_project(t, c))
        return jnp.sum(e.astype(jnp.float32))

    @jax.jit
    def reference(p):
        g = jax.grad(loss)(p)
        return (loss(p), optax.global_norm(g),
                optax.global_norm(jax.grad(lambda q: tower(q, "image"))(p)),
                optax.global_norm(jax.grad(lambda q: tower(q, "text"))(p)), g)

    *norms, grads = reference(params)
    want = dict(zip(("loss_fwd", "grads", "image_fwd_bwd", "text_fwd_bwd"),
                    map(float, norms)))
    for name, value in want.items():
        np.testing.assert_allclose(fns[name]().item(), value, rtol=1e-4,
                                   err_msg=name)

    tx, set_lr = _jax_adamw(params)

    @jax.jit
    def update(p, g):
        state = set_lr(tx.init(p), train_attrib.LR)
        updates, state = tx.update(g, state, p)
        moments = [leaf for path, leaf in
                   jax.tree_util.tree_flatten_with_path(state)[0]
                   if any(getattr(k, "name", None) in ("mu", "nu")
                          for k in path)]
        return (optax.global_norm(optax.apply_updates(p, updates)),
                optax.global_norm(moments))

    new_norm, moments_norm = map(float, update(params, grads))
    fns["optimizer"]()
    got = train_attrib.update_norms(port, opt)
    np.testing.assert_allclose(got["params"], new_norm, rtol=1e-4)
    np.testing.assert_allclose(got["moments"], moments_norm, rtol=1e-4)


# -- components: JAX's lanes, the filter, main -----------------------------------

def _jax_component_lanes():
    """JAX's lane names in its order: its ``results[...]`` keys, the
    f-strings expanded over their loops."""
    names = []
    for key in re.findall(r'results\[(f?"[^"]+")\] =', _jax_tool_source(
            "benchmark_components")):
        if key.startswith("f"):
            body = key[2:-1]
            names += ([body.replace("{backend}", b) for b in ("pallas", "xla")]
                      if "{backend}" in body else
                      [body.replace("{tome_r}", str(r)) for r in (8, 16)])
        else:
            names.append(key[1:-1])
    return list(dict.fromkeys(names))


@pytest.mark.parametrize("only", ["", "train", "tome", "image_tower_fwd",
                                  "seg", "int8", "tome16", "nothing"])
def test_component_lanes_and_filter_are_jax(only):
    jax_lanes = _jax_component_lanes()
    assert list(components.LANES) == jax_lanes
    # JAX's want(): a lane runs when --only is empty or a substring of it
    assert components.lanes(only) == [n for n in jax_lanes
                                      if (only in n if only else True)]


def test_components_main_runs_every_lane_at_a_toy_size(monkeypatch, capsys):
    monkeypatch.setitem(components.FLAGSHIP, "image_tag", "vit_test")
    monkeypatch.setitem(components.FLAGSHIP, "img_size", 32)
    monkeypatch.setitem(components.FLAGSHIP, "text_tag", "bert_test")
    monkeypatch.setitem(components.FLAGSHIP, "projection_dim", 16)
    monkeypatch.setitem(components.FLAGSHIP, "image_k", 3)
    results = components.main(["--device", "cpu", "--batch", "2",
                               "--iters", "1"])
    assert list(results) == list(components.LANES)
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    out = capsys.readouterr().out
    assert "card: cpu, host clock" in out
    assert "train-step MFU not printed: no peak: a CPU run measures no card" in out


@pytest.mark.parametrize("name", TOOLS)
def test_tool_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    tool = importlib.import_module(f"simseg_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tool.main([])


def _imported_roots(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ("bench_common",) + TOOLS)
def test_tool_imports_neither_jax_nor_the_repos_tools(name):
    """No import of ``jax``, ``simseg_tpu`` or the repo's ``tools`` package
    in the tool's source (``tests/test_torch_port_foundation.py`` imports
    every port module in a fresh interpreter and finds no JAX there)."""
    path = os.path.join(ROOT, "simseg_tpu_torch", "tools", f"{name}.py")
    assert not set(_imported_roots(path)) & {"jax", "flax", "optax",
                                               "simseg_tpu", "tools"}
