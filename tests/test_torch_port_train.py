"""PyTorch port (simseg_tpu_torch): the training slice — schedules, losses,
the optimizer, the train step, the runner and native checkpoints — held
against the JAX package on the same numpy inputs and converted parameters.

Both sides run float32 on the CPU (JAX matmuls at 'highest', set in
tests/conftest.py). Bars: schedules to 1e-12 (the same float64 Python
arithmetic); losses and accuracies to 1e-6 and their gradients to 1e-5 (f32
sums in another order); optimizer updates to 1e-6 after 3 steps; the train
step's loss to 1e-5 relative, its gradient norm to 1e-4 relative and the
parameters after 3 steps to 1e-5 (Adam divides each gradient by its own
scale, so f32 noise in a small gradient moves a parameter by up to lr times
that noise's relative size); in bf16 the loss to 2e-2 relative (both round
activations to bf16, at other places). The runner's resumed run equals the
uninterrupted one exactly.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import simseg_tpu.ops.losses as jax_losses
from simseg_tpu import config as jax_config
from simseg_tpu.core.lr_schedule import build_schedule as jax_build_schedule
from simseg_tpu.core.optim import _param_labels as jax_param_labels
from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import clip_loss_fn as jax_clip_loss_fn
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.engine.train_step import mixup_lambda as jax_mixup_lambda
from simseg_tpu.tasks.clip import config as jax_clip_config
import simseg_tpu_torch.ops.losses as losses
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.convert import (flax_param_path,
                                                 flax_params_to_state_dict)
from simseg_tpu_torch.checkpoint.native import (LATEST, has_checkpoint,
                                                load_checkpoint, save_checkpoint)
from simseg_tpu_torch.core.hooks import Hook, Priority
from simseg_tpu_torch.core.lr_schedule import build_schedule
from simseg_tpu_torch.core.optim import build_optimizer, param_label
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.engine import train_step
from simseg_tpu_torch.engine.train_step import clip_loss_fn, make_train_step
from simseg_tpu_torch.models.clip import CLIPModel, build_clip_model
from simseg_tpu_torch.tasks.clip import config as clip_config
from simseg_tpu_torch.tasks.clip.train import train
from tests.test_models import tiny_clip

torch.set_num_threads(2)

SEQ = 8
TINY = ["model.image_encoder.tag=vit_test", "model.text_encoder.tag=bert_test",
        "transforms.input_size=32", "model.projection.dim=16",
        "model.pool.name=loda", "model.pool.loda.image_k=3",
        "model.pool.loda.text_k=1", "model.max_length=8",
        "loss.temperature.name=parameter", "dist.bf16=false"]


def _trees(argv):
    """(port cfg, JAX cfg) from the default bank and the same overrides."""
    ours = config.update_cfg(clip_config.task_cfg_init_fn, None, argv,
                             preprocess_fn=clip_config.update_clip_config,
                             target=config.new_base_cfg())
    ref = jax_config.update_cfg(jax_clip_config.task_cfg_init_fn, None, argv,
                                preprocess_fn=jax_clip_config.update_clip_config,
                                target=jax_config.new_base_cfg())
    return ours, ref


# ---------------------------------------------------------------- schedules

SCHEDULES = {
    "constant_schedule": {},
    "constant_schedule_with_warmup": {},
    "linear_schedule_with_warmup": {},
    "multi_step_schedule_with_warmup": {"milestone_steps": [30, 60], "gamma": 0.5},
    "cosine_schedule_with_warmup": {"num_cycles": 0.5},
    "cosine_schedule_with_warmup_min_lr_scale": {"num_cycles": 0.5,
                                                 "min_lr_scale": 0.1},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    ours, ref = _trees([f"optim.lr.name={name}", "optim.lr.init=3e-4",
                        "optim.lr.warmup_proportion=0.1",
                        f"optim.lr.param={SCHEDULES[name]!r}"])
    fn, jfn = build_schedule(ours, 100), jax_build_schedule(ref, 100)
    for step in range(121):
        assert abs(fn(step) - jfn(step)) <= 1e-12, step


# ------------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=1, keepdims=True)
    ignore = np.zeros(8, np.float32)
    ignore[[2, 5]] = 1
    return f1, f2, np.float32(0.05), ignore


LOSSES = {
    "info_nce": lambda L, a, b, t, m: L.info_nce(a, b, t),
    "info_nce_ignore_smoothing": lambda L, a, b, t, m: L.info_nce(
        a, b, t, ignore_mask=m, smoothing=0.1),
    "info_nce_group": lambda L, a, b, t, m: L.info_nce(a, b, t, group_size=4),
    "symmetric_info_nce": lambda L, a, b, t, m: L.symmetric_info_nce(
        a, b, t, m, 0.1, 4),
    "mixup_nce": lambda L, a, b, t, m: L.mixup_nce(
        a, b, t, 0.7, flip_block=4, ignore_mask=m, smoothing=0.1),
    "mixup_nce_group": lambda L, a, b, t, m: L.mixup_nce(
        a, b, t, 0.7, flip_block=2, group_size=4),
    "mse_embedding_loss": lambda L, a, b, t, m: L.mse_embedding_loss(
        a, b, ignore_mask=m),
    "triplet_max": lambda L, a, b, t, m: L.triplet_loss(a, b, 0.2, "max"),
    "triplet_mean": lambda L, a, b, t, m: L.triplet_loss(a, b, 0.2, "mean"),
}


def _scalars(out):
    """(loss, [accuracies]) of any loss's return value."""
    loss, *rest = out
    accs = []
    for r in rest:
        accs += list(r.values()) if isinstance(r, dict) else [r]
    return loss, accs


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name):
    f1, f2, temp, ignore = _loss_inputs()
    fn = LOSSES[name]
    args = [torch.tensor(x, requires_grad=True) for x in (f1, f2, temp)]
    loss, accs = _scalars(fn(losses, *args, torch.from_numpy(ignore)))
    grads = torch.autograd.grad(loss, args, allow_unused=True)

    jargs = [jnp.asarray(x) for x in (f1, f2, temp)]
    jloss, jaccs = _scalars(fn(jax_losses, *jargs, jnp.asarray(ignore)))
    jgrads = jax.grad(lambda *a: _scalars(fn(jax_losses, *a, jnp.asarray(ignore)))[0],
                      argnums=(0, 1, 2))(*jargs)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose([float(a) for a in accs],
                               [float(a) for a in jaccs], rtol=1e-6, atol=1e-6)
    for g, jg in zip(grads, jgrads):
        g = np.zeros(np.shape(jg)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_cross_entropies_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    targets = rng.integers(0, 5, 6)
    probs = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    np.testing.assert_allclose(
        losses.label_smoothing_ce(torch.from_numpy(logits),
                                  torch.from_numpy(targets), 0.1).numpy(),
        np.asarray(jax_losses.label_smoothing_ce(jnp.asarray(logits),
                                                 jnp.asarray(targets), 0.1)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        losses.soft_target_ce(torch.from_numpy(logits),
                              torch.from_numpy(probs)).numpy(),
        np.asarray(jax_losses.soft_target_ce(jnp.asarray(logits),
                                             jnp.asarray(probs))),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- models and params

_FIELDS = ("image_tag", "img_size", "image_arch", "text_tag", "text_arch",
           "target_token_idx", "projection_name", "projection_dim",
           "pool_name", "image_k", "text_k", "temperature_name",
           "temperature_init")


def _pair(dtype=jnp.float32, seed=0, **over):
    """(flax model, its params as numpy, the port model with them)."""
    flax_model = tiny_clip(dtype=dtype, **over)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, SEQ), jnp.int32),
             "attention_mask": jnp.ones((1, SEQ), jnp.int32)}
    params = jax.tree.map(np.asarray,
                          flax_model.init(jax.random.key(seed), dummy))
    port = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS},
                     compute_dtype=None if dtype == jnp.float32 else torch.bfloat16)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def test_flax_param_path_inverts_the_converter():
    """Every port parameter maps back to the JAX leaf it was converted from
    (the complex projection included)."""
    flax_model = tiny_clip(projection_name="complex")
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, SEQ), jnp.int32),
        "attention_mask": jnp.ones((1, SEQ), jnp.int32)}))
    for path, leaf in _flat_paths(params):
        single = {"params": {}}
        node = single["params"]
        keys = path.split("/")[1:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
        (name,) = flax_params_to_state_dict(single)
        assert flax_param_path(name) == path


RULES = {"blocks0": {"regex": r"image_encoder/blocks_0/"},
         "norms": {"pattern": r"(norm|LayerNorm|layer_norm)[^/]*/(scale|bias)$"},
         "temp": {"pattern": r"temperature$"}}
FROZEN = (r"^params/text_encoder/layer_1/", r"^params/text_projection/")


def test_rules_select_the_same_tensors_in_both_packages():
    _, params, port = _pair()
    labels = dict(_flat_paths(jax_param_labels(params, RULES, FROZEN)))
    ours = {flax_param_path(n): param_label(flax_param_path(n), RULES, FROZEN)
            for n, _ in port.named_parameters()}
    assert ours == labels
    assert set(labels.values()) == {"blocks0", "norms", "temp", "_frozen",
                                     "default"}


# ---------------------------------------------------------------- optimizer

OPTIMIZERS = {
    "adamw_rules_frozen_clip": (
        ["optim.name=torch.optim.AdamW",
         "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.05}",
         "optim.param_group_rules={'vit0': {'regex': 'image_encoder/blocks_0', "
         "'param': {'lr': 5e-3, 'weight_decay': 0.0}}, 'proj': {'pattern': "
         "'projection', 'lr_mult': 0.5}}",
         "optim.grad_clip={'max_norm': 1.0}"], FROZEN, None),
    "adam_coupled_decay": (
        ["optim.name=torch.optim.Adam",
         "optim.param={'weight_decay': 0.01}"], (), None),
    "sgd_momentum_clip": (
        ["optim.name=torch.optim.SGD",
         "optim.param={'momentum': 0.8, 'weight_decay': 0.001}",
         "optim.grad_clip={'max_norm': 0.5}"], (), None),
    "adamw_skip_nonfinite": (
        ["optim.name=torch.optim.AdamW", "optim.skip_nonfinite=1",
         "optim.param={'weight_decay': 0.1}"], (), 1),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    argv, frozen, nan_step = OPTIMIZERS[name]
    ours_cfg, ref_cfg = _trees(TINY + ["optim.lr.init=1e-3"] + argv)
    _, params, port = _pair()
    tx, set_lr = jax_build_optimizer(ref_cfg, params, frozen_patterns=frozen)
    opt = build_optimizer(ours_cfg, port, frozen_patterns=frozen)
    state = tx.init(params)
    named = dict(port.named_parameters())
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: np.asarray(rng.normal(size=p.shape) * 0.1, np.float32),
            params)
        if step == nan_step:
            grads["params"]["temperature"] = np.asarray(np.nan, np.float32)
        lr = 1e-3 * (step + 1)
        state = set_lr(state, lr)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for key, g in flax_params_to_state_dict(grads).items():
            named[key].grad = g
        opt.set_lr(lr)
        opt.step()
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


# gradient accumulation (optim.grad_accum_steps = 2, optax MultiSteps):
# name -> (overrides, step whose gradients hold a NaN, or None)
ACCUMULATION = {
    "adamw_clip_guard": (
        ["optim.name=torch.optim.AdamW", "optim.skip_nonfinite=1",
         "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.05}",
         "optim.grad_clip={'max_norm': 0.5}"], 2),
    "sgd_clip": (
        ["optim.name=torch.optim.SGD",
         "optim.param={'momentum': 0.8, 'weight_decay': 0.001}",
         "optim.grad_clip={'max_norm': 0.5}"], None),
}


@pytest.mark.parametrize("name", list(ACCUMULATION))
def test_grad_accumulation_matches_jax_multisteps(name):
    """Four steps of k = 2 with a changing lr against JAX's optimizer chain
    under ``optax.MultiSteps``: the mean of two steps' gradients is clipped
    and applied on every second step, the guard judging the mean (a NaN in
    step 2's gradients skips the second update); AdamW's count moves once a
    window; the reported norm is each step's own."""
    argv, nan_step = ACCUMULATION[name]
    ours_cfg, ref_cfg = _trees(TINY + ["optim.lr.init=1e-3",
                                       "optim.grad_accum_steps=2"] + argv)
    _, params, port = _pair()
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = tx.init(params)
    opt = build_optimizer(ours_cfg, port)
    named = dict(port.named_parameters())
    rng = np.random.default_rng(4)
    for step in range(4):
        grads = jax.tree.map(
            lambda p: np.asarray(rng.normal(size=p.shape) * 0.1, np.float32),
            params)
        if step == nan_step:
            grads["params"]["temperature"] = np.asarray(np.nan, np.float32)
        lr = 1e-3 * (step + 1)
        state = set_lr(state, lr)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for key, g in flax_params_to_state_dict(grads).items():
            named[key].grad = g
        opt.set_lr(lr)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        assert opt.mini_step == (step + 1) % 2
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)
    if name.startswith("adamw"):
        counts = {int(s["step"]) for s in opt.base.state.values()}
        assert counts == {1}   # the second window was skipped


def test_lars_builds_and_steps_as_optax_lars():
    """LARS, once refused here until the linear probe came, now builds and
    takes a step as ``optax.lars`` does (the full comparison is in
    ``tests/test_torch_port_cnn.py``)."""
    from simseg_tpu_torch.core.optim import LARS

    ours_cfg, ref_cfg = _trees(TINY + ["optim.name=LARS",
                                       "optim.param={'weight_decay': 1e-4}"])
    _, params, port = _pair()
    opt = build_optimizer(ours_cfg, port)
    assert isinstance(opt.base, LARS)
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = set_lr(tx.init(params), 0.5)
    grads = jax.tree.map(lambda p: np.full(p.shape, 0.01, np.float32), params)
    updates, _ = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(port.named_parameters())
    for key, g in flax_params_to_state_dict(grads).items():
        named[key].grad = g
    opt.set_lr(0.5)
    opt.step()
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_float32_master_weights_survive_a_bf16_step():
    """bf16 compute, float32 parameters: an AdamW step at lr 1e-4 moves
    nearly every weight, by less than the bf16 spacing of most of them — a
    model whose parameters were themselves bf16 would round it away."""
    ours_cfg, _ = _trees(TINY + ["dist.bf16=true", "optim.lr.init=1e-4",
                                 "optim.param={'weight_decay': 0.0}"])
    torch.manual_seed(0)
    model = build_clip_model(ours_cfg)
    assert model.vit.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    step = make_train_step(model, build_optimizer(ours_cfg, model))
    before = model.vit.blocks[0].attn.qkv.weight.detach().clone()
    metrics = step(_batches(1)[0], 1e-4)
    assert torch.isfinite(metrics["loss"])
    delta = model.vit.blocks[0].attn.qkv.weight.detach() - before
    assert (delta != 0).float().mean() > 0.95
    kept_in_bf16 = (before + delta).bfloat16() != before.bfloat16()
    assert kept_in_bf16.float().mean() < 0.5


# --------------------------------------------------------------- train step

def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((4, SEQ), np.int64)
        mask[1, 5:] = 0
        mask[3, 3:] = 0
        out.append({"image": torch.from_numpy(
                        rng.normal(size=(4, 32, 32, 3)).astype(np.float32)),
                    "input_ids": torch.from_numpy(rng.integers(0, 128, (4, SEQ))),
                    "attention_mask": torch.from_numpy(mask)})
    return out


FLAGSHIP_OPTIM = ["optim.name=torch.optim.AdamW",
                  "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, "
                  "'weight_decay': 0.001}",
                  "optim.lr.name=cosine_schedule_with_warmup_min_lr_scale",
                  "optim.lr.init=1e-4", "optim.lr.warmup_proportion=0.025",
                  "optim.lr.param={'num_cycles': 0.5, 'min_lr_scale': 0.1}"]


LOSS_NAMES = {"NCE": {}, "MSE": {}, "Triplet": {"triplet_reduce": "mean"},
              "NCE+MSE": {"extra_losses": ("MSE",)},
              "MixUpNCE": {"mixup_alpha_param": 0.4}}


@pytest.mark.parametrize("name", list(LOSS_NAMES))
def test_clip_loss_fn_matches_jax(monkeypatch, name):
    """Loss, accuracies and temperature of one forward; MixUpNCE with the
    lambda JAX draws for step 0 without a key (the two frameworks' random
    numbers differ)."""
    flax_model, params, port = _pair()
    kw = dict(LOSS_NAMES[name], smoothing=0.1, loss_name=name.split("+")[0])
    if name == "MixUpNCE":
        lam = float(jax_mixup_lambda(None, 0, 0.4))
        assert 0.5 <= lam <= 1.0
        monkeypatch.setattr(train_step, "mixup_lambda", lambda *a: lam)
    batch = _batches(1)[0]
    jloss, jm = jax_clip_loss_fn(flax_model, params, {
        k: jnp.asarray(v.numpy()) for k, v in batch.items()}, None, step=0, **kw)
    loss, m = clip_loss_fn(port, batch, **kw)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_complex_projection_dropout_only_when_not_deterministic():
    """The complex head drops out only when the step asks for it
    (``runner.stable_random`` set, as the JAX step passes an rng)."""
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_name="complex", projection_dim=16,
                      projection_dropout=0.5)
    batch = _batches(1)[0]
    with torch.no_grad():
        a, b = model(batch)[0], model(batch)[0]
        c = model(batch, deterministic=False)[0]
    assert torch.equal(a, b) and not torch.allclose(a, c)
    cfg, _ = _trees(TINY + ["model.projection.name=complex",
                            "runner.stable_random=step"])
    runner = CLIPRunner(cfg, build_clip_model(cfg), {"train": [_batches(1)]},
                        device="cpu")
    seen = []
    runner._step_fn = lambda b, lr, step, det: seen.append(det) or {}
    runner.batch_processor(_batches(1)[0])
    assert seen == [False]


# bf16 at temperature 0.07, f32 at the flagship's 0.02: at 0.02 the 50x
# logit scale turns the two frameworks' bf16 rounding of the embeddings
# (cosine 0.99998 between them) into loss differences of 0.5% at the first
# step and 3% after one Adam step (whose first update is +-lr for every
# weight, whatever the gradient's size), on this tiny random model
@pytest.mark.parametrize("dtype,temperature", [("float32", 0.02),
                                               ("bfloat16", 0.07)])
def test_train_step_matches_jax(dtype, temperature):
    ours_cfg, ref_cfg = _trees(TINY + FLAGSHIP_OPTIM)
    flax_model, params, port = _pair(getattr(jnp, dtype),
                                     temperature_init=temperature)
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    jstep = jax_make_train_step(flax_model, tx, set_lr, donate=False)
    step = make_train_step(port, build_optimizer(ours_cfg, port))
    schedule = build_schedule(ours_cfg, 3)
    for i, batch in enumerate(_batches(3)):
        lr = schedule(i)
        state, jm = jstep(state, {k: jnp.asarray(v.numpy()) for k, v in
                                  batch.items()}, None, lr)
        m = step(batch, lr, i)
        if dtype == "bfloat16":
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                       rtol=2e-2)
            continue
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
    if dtype == "float32":
        want = flax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
        drift = 2 * sum(schedule(i) for i in range(3))
        for key, value in port.state_dict().items():
            a, b = value.numpy(), want[key].numpy()
            keys = _key_bias(key, a.size)
            if keys is not None:
                # the key bias's gradient is zero in exact arithmetic (the
                # softmax is invariant to a shift of a query's scores); Adam
                # scales either side's f32 noise there to +-lr a step
                assert np.all(np.abs(a[keys] - b[keys]) <= drift), key
                a, b = np.delete(a, keys), np.delete(b, keys)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)


def _key_bias(name, size):
    """The entries of a key-projection bias within ``name``, or None."""
    if name.endswith("attn.qkv.bias"):
        return np.arange(size // 3, 2 * size // 3)
    if name.endswith("attention.self.key.bias"):
        return np.arange(size)
    return None


# ------------------------------------------------------ runner, checkpoints

class _Record(Hook):
    def __init__(self, stop_after=None):
        self.lrs, self.stop_after = [], stop_after

    def after_train_step(self, runner):
        self.lrs.append(runner.outputs["lr"])
        if runner.step == self.stop_after:
            raise KeyboardInterrupt("interrupted")


def _runner(argv, loader, hook):
    cfg, _ = _trees(TINY + FLAGSHIP_OPTIM + argv)
    torch.manual_seed(0)
    runner = CLIPRunner(cfg, build_clip_model(cfg), {"train": [loader]},
                        device="cpu")
    runner.register_hook(hook, Priority.LOWEST)
    return runner, cfg


def test_runner_runs_train_steps_with_the_jax_lr_sequence(tmp_path):
    hook = _Record()
    runner, cfg = _runner([f"ckpt.dir={tmp_path}", "data.train_steps=3",
                           "epoch=2", "optim.lr.warmup_proportion=0.25"],
                          _batches(5), hook)
    runner.run()
    _, ref_cfg = _trees(TINY + FLAGSHIP_OPTIM + ["optim.lr.warmup_proportion=0.25"])
    want = [jax_build_schedule(ref_cfg, 6)(s) for s in range(6)]
    assert runner.step == 6 and runner.total_steps == 6
    assert hook.lrs == want
    assert os.path.isdir(os.path.join(cfg.ckpt.dir, "epoch_002"))


def test_resumed_run_equals_uninterrupted(tmp_path):
    argv = ["data.train_steps=4", "epoch=1", "ckpt.step_interval=2"]
    whole, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'a'}"], _batches(4), _Record())
    whole.run()

    cut, cfg = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4),
                       _Record(stop_after=2))
    with pytest.raises(KeyboardInterrupt):
        cut.run()
    hook = _Record()
    resumed, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4), hook)
    resumed.run()
    assert len(hook.lrs) == 2 and resumed.step == 4
    for (key, a), b in zip(whole.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_resume_mid_accumulation_equals_uninterrupted(tmp_path):
    """``optim.grad_accum_steps=2``, a checkpoint after step 3, halfway
    through the second window: the resumed run's parameters equal the
    uninterrupted run's, and AdamW moved once a window."""
    argv = ["data.train_steps=4", "epoch=1", "ckpt.step_interval=3",
            "optim.grad_accum_steps=2"]
    whole, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'a'}"], _batches(4), _Record())
    whole.run()
    cut, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4),
                     _Record(stop_after=3))
    with pytest.raises(KeyboardInterrupt):
        cut.run()
    assert cut.optimizer.mini_step == 1
    hook = _Record()
    resumed, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4), hook)
    resumed.run()
    assert len(hook.lrs) == 1 and resumed.step == 4
    assert {int(s["step"]) for s in resumed.optimizer.base.state.values()} == {2}
    for (key, a), b in zip(whole.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_checkpoint_resave_prunes_the_old_version(tmp_path):
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16)
    for step in (2, 4):
        save_checkpoint(str(tmp_path), "step_checkpoint", model,
                        meta={"step": step, "epoch": 0, "inner_step": step})
    assert sorted(os.listdir(tmp_path)) == [LATEST, "step_checkpoint@4"]
    assert has_checkpoint(str(tmp_path))
    meta = load_checkpoint(str(tmp_path), model)
    assert meta["step"] == 4


def test_external_resume_loads_parameters_only(tmp_path):
    """``ckpt.external_resume`` to a native checkpoint: its parameters, a
    fresh optimizer and step 0."""
    src_cfg, _ = _trees(TINY + [f"ckpt.dir={tmp_path / 'src'}",
                                "data.train_steps=2", "epoch=1"])
    src = train(src_cfg, {"train": [_batches(2)]}, device="cpu")
    runner, _ = _runner([f"ckpt.dir={tmp_path / 'dst'}", "data.train_steps=1",
                         "epoch=0", f"ckpt.external_resume={src_cfg.ckpt.dir}"],
                        _batches(1), _Record())
    runner.run()
    assert runner.step == 0 and not runner.optimizer.base.state
    for (key, a), b in zip(src.model.state_dict().items(),
                           runner.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_train_entry_tokenizes_captions(tmp_path):
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab

    cfg, _ = _trees(TINY + [f"ckpt.dir={tmp_path}", "data.train_steps=2",
                            "epoch=1"])
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 255, (4, 32, 32, 3)).astype(np.uint8),
             "caption": ["a cat", "a dog", "two cats", "a dog and a cat"]}
    runner = train(cfg, {"train": [[batch] * 3]},
                   tokenizer=WordPieceTokenizer(make_test_vocab(["cat", "dog"])),
                   device="cpu")
    assert runner.step == 2 and np.isfinite(float(runner.outputs["loss"]))
    assert has_checkpoint(cfg.ckpt.dir)
    assert list(itertools.islice(runner.model.parameters(), 1))[0].device.type == "cpu"


def test_a_finished_run_puts_the_sigterm_handler_back(tmp_path):
    """``PreemptionHook`` takes SIGTERM for the run only: after ``train``
    returns, the handler the process had is installed again."""
    import signal

    def mine(signum, frame):
        raise AssertionError("not called")

    before = signal.signal(signal.SIGTERM, mine)
    try:
        cfg, _ = _trees(TINY + [f"ckpt.dir={tmp_path}", "data.train_steps=1",
                                "epoch=1"])
        runner = train(cfg, {"train": [_batches(1)]}, device="cpu")
        assert runner.step == 1
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, before)


class _Val(Hook):
    def __init__(self):
        self.passes = []

    def after_val_epoch(self, runner):
        self.passes.append((runner.step, runner.state.val_steps,
                            runner.state.retrieval_summary["rsum"]))


def test_runner_validates_at_epoch_end_and_caps_val_steps(tmp_path):
    """With ``runner.val_interval_steps`` < 0 the validation runs at each
    ``val_interval``-th epoch's end (JAX ``EpochRunner.run``), capped at
    ``data.val_steps`` batches; the model is back in train mode after."""
    val = [dict(b, image_id=np.arange(4) // 2, caption_id=np.arange(4))
           for b in _batches(3, seed=9)]
    cfg, _ = _trees(TINY + FLAGSHIP_OPTIM + [
        f"ckpt.dir={tmp_path}", "data.train_steps=2", "epoch=2",
        "runner.val_interval=2", "runner.val_interval_steps=-1",
        "data.val_steps=2"])
    torch.manual_seed(0)
    runner = CLIPRunner(cfg, build_clip_model(cfg),
                        {"train": [_batches(2)], "val": [val]}, device="cpu")
    hook = _Val()
    runner.register_hook(hook, Priority.LOWEST)
    runner.run()
    assert [p[:2] for p in hook.passes] == [(4, 2)]
    assert 0 < hook.passes[0][2] <= 600 and runner.model.training
