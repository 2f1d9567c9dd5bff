"""PyTorch port (simseg_tpu_torch): the Switch top-1 MoE towers
(``ops/moe.py``), their training aux and expert parallelism against the
JAX package (``simseg_tpu/ops/moe.py``, ``tests/test_moe.py``).

Both sides take the same seeded numpy inputs, the weights carried across
by ``checkpoint/convert.py``. Bars, float32 (JAX matmuls at 'highest'):
``MoEMlp`` outputs within 1e-5 and the aux within 1e-6 relative; the
towers' outputs within 1e-5 and their gradients within 1e-4 of each
gradient's largest entry (the towers' float32 bar of
``tests/test_torch_port_tome.py``); the CLIP step's loss and aux within
1e-5 relative and the parameters after the steps within JAX's own EP bars
(rtol 3e-4, atol 1e-6, ``tests/test_moe.py:139``). bf16: the outputs
within 2e-2 of the output's scale, both sides rounding activations to bf16
at other places; the routing (the expert of every token) the same. The
gloo worlds are built as ``tests/test_torch_port_tp.py`` builds them and
run against JAX's step on a mesh of as many of the 8 virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.checkpoint.torch_export import flax_to_torch
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import clip_loss_fn as jax_clip_loss_fn
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.models.linear_prob import \
    build_linear_prob_model as jax_build_probe
from simseg_tpu.ops.moe import MoEMlp as JaxMoEMlp
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_clip_init
from simseg_tpu_torch.checkpoint.convert import (flax_param_path,
                                                 flax_params_to_state_dict,
                                                 reference_state_dict)
from simseg_tpu_torch.core.optim import build_optimizer
from simseg_tpu_torch.engine.train_step import make_train_step
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.models.linear_prob import (LinearProbModel,
                                                 build_linear_prob_model)
from simseg_tpu_torch.ops.moe import MoEMlp, moe_aux
from simseg_tpu_torch.parallel.sharding import plan_specs
from tests.test_models import tiny_clip
from tests.test_seg_decode import _norm
from tests.test_torch_port_cnn import _message, _probe_trees
from tests.test_torch_port_distributed import _batch
from tests.test_torch_port_tp import (LR, SGD, jax_run, make_batches, ranks_of,
                                      run_cases)
from tests.test_torch_port_train import _FIELDS, SEQ, TINY, _key_bias, _trees

torch.set_num_threads(2)

MOE_ARCH = (("moe_experts", 2), ("moe_capacity", 4.0))
TOL = dict(rtol=1e-5, atol=1e-5)

# ---------------------------------------------------------------- the layer


def _layer_pair(e, cf, dtype=jnp.float32, d=6, h=8):
    jm = JaxMoEMlp(num_experts=e, hidden_dim=h, out_dim=d, capacity_factor=cf,
                   dtype=dtype)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), jnp.zeros((1, 5, d), dtype))["params"])
    port = MoEMlp(d, e, h, d, cf)
    port.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
        "router.bias": torch.from_numpy(params["router"]["bias"].copy()),
        **{k: torch.from_numpy(params[k].copy())
           for k in ("w1", "b1", "w2", "b2")}})
    return jm, params, port


# name -> (experts, capacity factor, masked, dtype)
LAYERS = {
    "f32": (2, 4.0, False, "float32"),
    "f32_mask": (2, 4.0, True, "float32"),
    "f32_overflow": (4, 0.5, False, "float32"),
    "f32_overflow_mask": (4, 0.5, True, "float32"),
    "f32_flagship_cf": (8, 1.25, True, "float32"),
    "bf16": (4, 1.25, False, "bfloat16"),
    "bf16_mask": (4, 1.25, True, "bfloat16"),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_layer_matches_jax(name):
    """Outputs, the aux and the routing of one layer: with the capacity
    overflowing some tokens are dropped (zero rows, as in JAX), and the
    mask takes padding out of routing, capacity and the aux."""
    e, cf, masked, dtype = LAYERS[name]
    jm, params, port = _layer_pair(e, cf, getattr(jnp, dtype))
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(3, 24, 6)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 24), np.int32)
        mask[0, 9:] = 0
        mask[2, 17:] = 0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jy, inter = jax.jit(lambda p, v, k: jm.apply(
        {"params": p}, v, True, k, mutable=["intermediates"]))(
        params, jx, None if mask is None else jnp.asarray(mask))
    jaux = float(np.asarray(jax.tree.leaves(inter)[0]))
    tdtype = getattr(torch, dtype)
    y = port(torch.from_numpy(x).to(tdtype),
             None if mask is None else torch.from_numpy(mask))
    aux = moe_aux(port)
    jy = np.asarray(jy, np.float32)
    got = y.float().detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, jy, **TOL)
        np.testing.assert_allclose(aux.item(), jaux, rtol=1e-6)
    else:
        scale = np.abs(jy).max()
        np.testing.assert_allclose(got / scale, jy / scale, rtol=0, atol=2e-2)
        np.testing.assert_allclose(aux.item(), jaux, rtol=1e-5)
    # dropped tokens: zero rows on both sides, the same ones
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0,
                                  np.abs(jy).sum(-1) == 0)
    if cf < 1:
        assert (np.abs(got).sum(-1) == 0).sum() > 0
    if masked:
        assert np.abs(got[mask == 0]).max() == 0.0


def test_moe_gelu_form_follows_the_dtype():
    """float32: exact erf-GELU; bf16: the tanh form (JAX ``approximate=
    dtype != float32``). A float32 layer given a tanh GELU misses JAX."""
    import simseg_tpu_torch.ops.moe as moe_mod

    jm, params, port = _layer_pair(2, 4.0)
    x = np.random.default_rng(3).normal(size=(2, 8, 6)).astype(np.float32) * 3
    jy = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tanh = lambda v: torch.nn.functional.gelu(v, approximate="tanh")  # noqa: E731
    orig = moe_mod.gelu
    moe_mod.gelu = tanh
    try:
        wrong = port(torch.from_numpy(x)).detach().numpy()
    finally:
        moe_mod.gelu = orig
    assert np.abs(wrong - jy).max() > 1e-4
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), jy,
                               **TOL)


# ---------------------------------------------------------------- the towers

def _clip_pair(dtype=jnp.float32, **over):
    flax_model = tiny_clip(dtype=dtype, **over)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, SEQ), jnp.int32),
             "attention_mask": jnp.ones((1, SEQ), jnp.int32)}
    params = jax.tree.map(np.asarray, jax.jit(flax_model.init)(
        jax.random.key(0), dummy))
    port = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS},
                     compute_dtype=None if dtype == jnp.float32
                     else torch.bfloat16)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port


TOWERS = {
    "both_2": dict(image_arch=MOE_ARCH, text_arch=MOE_ARCH),
    "both_4_every1": dict(
        image_arch=(("moe_experts", 4), ("moe_every", 1), ("depth", 3)),
        text_arch=(("moe_experts", 4), ("moe_every", 1))),
    "both_4_cf125": dict(image_arch=(("moe_experts", 4), ("depth", 4)),
                         text_arch=(("moe_experts", 4), ("moe_capacity", 0.5))),
}


def _mask_batch(n, seed):
    b = _batch(n, seed)
    b["attention_mask"][0, 4:] = 0
    b["attention_mask"][2, 6:] = 0
    return b


@pytest.mark.parametrize("name", list(TOWERS))
def test_moe_towers_forward_and_gradients_match_jax(name):
    """The CLIP forward (both embeddings) and every parameter's gradient
    of sum(img * G) + sum(txt * H) + aux against ``jax.grad``, the towers'
    aux summed over the MoE layers as JAX's step sums the sown values."""
    flax_model, params, port = _clip_pair(**TOWERS[name])
    batch = _mask_batch(4, 5)
    rng = np.random.default_rng(9)
    gi, gt = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))

    def jloss(p):
        (img, txt, _), inter = flax_model.apply(
            p, {k: jnp.asarray(v) for k, v in batch.items()},
            deterministic=True, mutable=["intermediates"])
        aux = sum(jnp.mean(v) for v in jax.tree.leaves(inter))
        return jnp.sum(img * gi) + jnp.sum(txt * gt) + aux, (img, txt, aux)

    (_, (jimg, jtxt, jaux)), jgrad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    img, txt, _ = port({k: torch.from_numpy(v) for k, v in batch.items()})
    aux = moe_aux(port)
    (torch.sum(img * torch.from_numpy(gi)) + torch.sum(txt * torch.from_numpy(gt))
     + aux).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), **TOL)
    np.testing.assert_allclose(txt.detach().numpy(), np.asarray(jtxt), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrad))
    moe_leaves = 0
    for n, p in port.named_parameters():
        w = want[n].numpy().ravel()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy().ravel()
        keys = _key_bias(n, w.size)
        if keys is not None:
            # zero in exact arithmetic: both sides hold float32 noise
            w, g = np.delete(w, keys), np.delete(g, keys)
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4,
                                   err_msg=n)
        moe_leaves += ".moe." in n
    assert moe_leaves >= 5


def test_moe_layout_and_text_mask_follow_jax():
    """Block 1 of each tower is MoE at moe_every 2 (JAX ``tests/test_moe.py:
    67-73, :96-101``), and garbage in the padded ids moves neither the
    aux nor the embeddings (the mask reaches the MoE layers)."""
    _, params, port = _clip_pair(image_arch=MOE_ARCH, text_arch=MOE_ARCH)
    names = dict(port.named_parameters())
    assert "image_encoder.model.model.blocks.0.mlp.fc1.weight" in names
    assert names["image_encoder.model.model.blocks.1.moe.w1"].shape == (2, 32, 128)
    assert "text_encoder.model.model.encoder.layer.0.intermediate.dense.weight" in names
    assert names["text_encoder.model.model.encoder.layer.1.moe.w1"].shape[0] == 2
    assert "text_encoder.model.model.encoder.layer.1.output.dense.weight" not in names
    batch = {k: torch.from_numpy(v) for k, v in _mask_batch(4, 2).items()}
    _, txt, _ = port(batch)
    aux = moe_aux(port).item()
    batch2 = dict(batch, input_ids=torch.where(batch["attention_mask"] > 0,
                                               batch["input_ids"], 99))
    _, txt2, _ = port(batch2)
    assert moe_aux(port).item() == pytest.approx(aux, rel=1e-6)
    torch.testing.assert_close(txt, txt2)


def test_moe_tower_bf16_routes_as_jax():
    """bf16 towers: the embeddings within bf16's bar, the aux within 1e-3."""
    flax_model, params, port = _clip_pair(jnp.bfloat16, image_arch=MOE_ARCH,
                                          text_arch=MOE_ARCH)
    batch = _mask_batch(4, 6)
    (jimg, jtxt, _), inter = jax.jit(lambda p, b: flax_model.apply(
        p, b, deterministic=True, mutable=["intermediates"]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jaux = sum(float(np.asarray(v, np.float32)) for v in jax.tree.leaves(inter))
    with torch.no_grad():
        img, txt, _ = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for a, b in ((img, jimg), (txt, jtxt)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=0, atol=2e-2)
    np.testing.assert_allclose(moe_aux(port).item(), jaux, rtol=1e-3)


# ---------------------------------------------------------------- the converter

def test_moe_converter_round_trip_and_strict_refusal():
    """Every MoE leaf maps to a port parameter and back to its JAX path
    (the optimizer's rules select the same leaves); the reference's layout
    has no slot for them: strict export refuses them as JAX's
    ``flax_to_torch`` does, non-strict leaves out the same leaves."""
    _, params, port = _clip_pair(image_arch=MOE_ARCH, text_arch=MOE_ARCH)
    state = port.state_dict()
    moe = [k for k in state if ".moe." in k]
    assert len(moe) == 12
    paths = set()
    for k in state:
        path = flax_param_path(k).split("/")
        node = params
        for p in path:
            node = node[p]
        paths.add("/".join(path))
        if k in moe:
            got = state[k].numpy()
            np.testing.assert_array_equal(got.T if path[-1] == "kernel" else got,
                                          np.asarray(node), err_msg=k)
    assert len(paths) == len(state)
    with pytest.raises(ValueError) as jerr:
        flax_to_torch(params, strict=True)
    with pytest.raises(ValueError) as err:
        reference_state_dict(state, strict=True)
    assert str(err.value) == str(jerr.value)
    jout, jrep = flax_to_torch(params, strict=False)
    out, rep = reference_state_dict(state, strict=False)
    assert sorted(out) == sorted(jout)
    assert rep["skipped"] == jrep["skipped"]


# ---------------------------------------------------------------- the step

MOE_STEP = (dict(image_arch=(("moe_experts", 4),),
                 text_arch=(("moe_experts", 2), ("moe_capacity", 2.0))),
            ("loss.moe_aux_weight=0.1",))


def test_moe_clip_step_matches_jax():
    """Three SGD-momentum steps of the one-process CLIP step with the aux
    (``loss.moe_aux_weight``) against JAX's ``make_train_step`` (JAX's own
    MoE step tests take SGD: Adam would scale either side's float32 noise
    in an expert's near-zero gradient to lr): loss, aux and gradient norm
    every step, the parameters after."""
    over, extra = MOE_STEP
    argv = TINY + SGD + list(extra)
    ours_cfg, ref_cfg = _trees(argv)
    flax_model, params, port = _clip_pair(**over)
    weight = float(ref_cfg.loss.moe_aux_weight)
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    jstep = jax_make_train_step(flax_model, tx, set_lr, donate=False,
                                moe_aux_weight=weight)
    step = make_train_step(port, build_optimizer(ours_cfg, port),
                           moe_aux_weight=weight)
    for i in range(3):
        batch = _mask_batch(8, 20 + i)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          None, LR)
        m = step({k: torch.from_numpy(v) for k, v in batch.items()}, LR, i)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["moe_aux"].item(), float(jm["moe_aux"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=3e-4,
                                   atol=1e-6, err_msg=key)


def test_moe_text_tower_beside_live_bn_image_tower():
    """A MoE text tower next to a CNN image tower with live BN (JAX
    ``tests/test_moe.py:222``): the aux is collected and the running
    statistics move, as JAX's loss function reports them."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    flax_model, params, port = _clip_pair(image_tag="resnet_test",
                                          text_arch=MOE_ARCH)
    batch = _mask_batch(8, 4)
    _, jm = jax.jit(lambda p, b: jax_clip_loss_fn(
        flax_model, p, b, None, bn_training=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    key = "image_encoder.model.model.bn1.running_mean"
    before = port.state_dict()[key].clone()
    loss, m = clip_loss_fn(port, {k: torch.from_numpy(v) for k, v in
                                  batch.items()}, bn_training=True)
    np.testing.assert_allclose(m["moe_aux"].item(), float(jm["moe_aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jm["loss"]), rtol=1e-5)
    want = flax_params_to_state_dict(
        {"params": params["params"],
         "batch_stats": jax.tree.map(np.asarray, jm["_new_batch_stats"])})
    assert not torch.equal(port.state_dict()[key], before)
    np.testing.assert_allclose(port.state_dict()[key].numpy(),
                               want[key].numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- seg eval

SEG_CLASSES = ["background", "dog", "cat", "bird", "tree", "car"]


def test_moe_seg_forward_matches_jax():
    """``make_seg_forward`` with an MoE image tower against JAX's: the
    predictions and the histograms equal."""
    flax_model, params, port = _clip_pair(image_arch=(("moe_experts", 4),
                                                      ("moe_capacity", 1.25)))
    port.eval()
    cfg = jax_update_cfg(jax_clip_init, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4"], target=jax_new_base_cfg())
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    tb = _norm(rng.normal(size=(len(SEG_CLASSES), 16))).astype(np.float32)
    labels = np.full((2, 64, 64), 255, np.int32)
    labels[:, :40, :48] = rng.integers(0, len(SEG_CLASSES), (2, 40, 48))
    gt_h, gt_w = np.array([40, 33]), np.array([48, 29])
    ji, ju, jpred = jax_seg_eval.make_seg_forward(
        flax_model, cfg, num_classes=6, top_cls_num=4, canvas=64, patch_size=8,
        return_pred=True)(params, jnp.asarray(images), jnp.asarray(tb),
                          jnp.asarray(labels), jnp.asarray(gt_h),
                          jnp.asarray(gt_w))
    i, u, pred = port_seg_eval.make_seg_forward(
        port, num_classes=6, top_cls_num=4, canvas=64, input_size=32,
        bilateral_stride=4, patch_size=8, return_pred=True, device="cpu")(
        *(torch.from_numpy(a) for a in (images, tb, labels, gt_h, gt_w)))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


# ---------------------------------------------------------------- the probe

def test_trainable_moe_probe_refused_frozen_builds():
    """JAX ``build_linear_prob_model``: a trainable MoE tower is refused with
    JAX's message; a frozen one builds and probes (its logits on JAX's)."""
    arch = "model.image_encoder.arch={'moe_experts': 4}"
    base = ["model.image_encoder.tag=vit_test", "transforms.input_size=32"]
    ours, ref = _probe_trees(base + ["model.image_encoder.trainable=true", arch])
    assert _message(build_linear_prob_model, ours) == _message(jax_build_probe,
                                                               ref)
    ours, ref = _probe_trees(base + ["model.image_encoder.trainable=false", arch,
                                     "dist.bf16=false"])
    model = build_linear_prob_model(ours)
    assert isinstance(model, LinearProbModel)
    jmodel = jax_build_probe(ref)
    images = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), {"image": jnp.asarray(images)}))
    model.load_state_dict(flax_params_to_state_dict(jparams), strict=True)
    jlogits = jax.jit(jmodel.apply)(jparams, {"image": jnp.asarray(images)})
    with torch.no_grad():
        logits = model({"image": torch.from_numpy(images)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


# ---------------------------------------------------------------- the worlds

# name -> (world, experts a tower, global batch, steps, settings, JAX options)
WORLD_CASES = {
    "dp2": (2, 4, 8, 2, [], {}),
    "ep2": (2, 4, 8, 2, ["dist.moe_ep=True"], {"ep": True}),
    "dp4": (4, 4, 8, 2, [], {}),
    "ep4": (4, 4, 8, 2, ["dist.moe_ep=True"], {"ep": True}),
}


def _world_arch(e):
    return dict(image_arch=(("moe_experts", e),),
                text_arch=(("moe_experts", e), ("moe_capacity", 2.0)))


@pytest.fixture(scope="module")
def moe_worlds(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    # the directories made here: pytest makes its base directory at the
    # first mktemp, which two threads would race to make
    tmps = {w: tmp_path_factory.mktemp(f"moe{w}") for w in (2, 4)}

    def world_of(world):
        tmp = tmps[world]
        batches, cases = {}, {}
        for name, (w, e, n, steps, argv, _) in WORLD_CASES.items():
            if w != world:
                continue
            batches.update(make_batches(name, n, steps, 500 + len(name)))
            cases[name] = {"argv": TINY + SGD + argv + [f"data.batch_size={n}"],
                           "steps": steps, "data": name}
        if world == 2:
            # ep2 again, a checkpoint written (gathered) and loaded (cut)
            # after its first step
            cases["ep2_resume"] = dict(cases["ep2"], resume_at=1)
        flax_model, params = run_cases(tmp, world, cases, batches,
                                       **_world_arch(4))
        return tmp, flax_model, params, batches

    # the two worlds at once
    with ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(world_of, w) for w in (2, 4)}
        return {w: job.result() for w, job in jobs.items()}


@pytest.mark.parametrize("name", list(WORLD_CASES))
def test_moe_world_matches_jax_mesh(moe_worlds, name):
    """MoE steps over W gloo ranks against JAX's step on a W-device mesh:
    under data parallelism the aux is the global batch's (JAX's GSPMD
    step sees the whole batch), under ``dist.moe_ep`` each rank holds E / W
    experts (its bytes the rules'), the all-to-alls in the layers; losses
    and aux within 1e-4 relative, the gathered parameters within JAX's
    bars, every rank's gathered state bit-equal."""
    world, e, n, steps, _, opts = WORLD_CASES[name]
    tmp, flax_model, params, batches = moe_worlds[world]
    ranks = ranks_of(tmp, name, world)
    for other in ranks[1:]:
        assert other["losses"] == ranks[0]["losses"]
        assert other["aux"] == ranks[0]["aux"]
        for k, v in ranks[0]["full"].items():
            assert torch.equal(v, other["full"][k]), k
    opts = dict(opts)
    losses, want = jax_run(flax_model, params, batches, name, world, n, steps,
                           opts)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["aux"], opts["aux"], rtol=1e-4)
    for key, value in ranks[0]["full"].items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=3e-4, atol=1e-6, err_msg=key)
    w1 = "image_encoder.model.model.blocks.1.moe.w1"
    model = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    specs = plan_specs(model, ep_ranks=world if opts.get("ep") else 1)
    want_bytes = 0
    for spec in specs.values():
        want_bytes += 4 * int(np.prod(spec.shape)) // (
            world if spec.ep_dim is not None else 1)
    for r, rank in enumerate(ranks):
        assert rank["bytes"] == (want_bytes, want_bytes)
        local = rank["local"][w1]
        assert local.shape[0] == (e // world if opts.get("ep") else e)
        if opts.get("ep"):
            chunk = ranks[0]["full"][w1].chunk(world)[r]
            assert torch.equal(local, chunk)


def test_moe_towers_export_for_serving(tmp_path):
    """The retrieval artifact of MoE towers (``serving.make_embed_fn``
    through ``torch.export``, the batch dynamic) loads and gives the live
    module's embeddings bit for bit at two batch sizes."""
    from simseg_tpu_torch import serving

    _, _, port = _clip_pair(image_arch=(("moe_experts", 4),),
                            text_arch=(("moe_experts", 2),))
    fn = serving.make_embed_fn(port, device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in _mask_batch(n, n).items()}
               for n in (4, 6)]
    args = [(b["image"], b["input_ids"], b["attention_mask"]) for b in batches]
    path = str(tmp_path / "moe.pt2")
    serving.save_artifact(path, serving.export_artifact(fn, args[0]))
    loaded = serving.load_artifact(path)
    for a in args:
        for got, want in zip(loaded(*a), fn(*a)):
            assert torch.equal(got, want)


def test_moe_ep_checkpoint_resume_is_bit_equal(moe_worlds):
    """``dist.moe_ep`` over 2 ranks, a checkpoint after step 1 (the experts
    gathered whole, rank 0 writing) and a fresh runner loading it (cut to
    each rank's experts again): the second step and the final state equal
    the uninterrupted run's bit for bit."""
    tmp = moe_worlds[2][0]
    resumed, straight = ranks_of(tmp, "ep2_resume", 2), ranks_of(tmp, "ep2", 2)
    for a, b in zip(resumed, straight):
        assert a["losses"] == b["losses"]
        for k, v in b["full"].items():
            assert torch.equal(a["full"][k], v), k
        w1 = "image_encoder.model.model.blocks.1.moe.w1"
        assert a["local"][w1].shape[0] == 2
