"""PyTorch port (simseg_tpu_torch): the CNN towers (ResNet, ConvNeXt,
EfficientNet), flax's BatchNorm, LARS, the CNN checkpoint layouts, the
grid step of the seg eval and the refusals, held against the JAX package
on the CPU. Weights go through the port's converter
(``checkpoint/convert.py``); inputs are made with numpy from a seed.

Bars: each tower's map in float32 within 1e-4 of its largest entry (an
input size the stride does not divide among them); BN's running
statistics after two live-BN forwards within rtol 1e-5 (and 1e-5 of each
buffer's largest entry, for the means near 0 of a deep layer, whose maps
carry float32 summation noise), and PyTorch's own
training-mode update (the unbiased variance) outside it; LARS parameters
after 5 steps across the warmup within JAX's mesh bar (rtol 2e-4, atol
1e-6); both checkpoint directions bit-equal; refusals with JAX's messages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from simseg_tpu.checkpoint.torch_bridge import load_clip_checkpoint as jax_load_clip
from simseg_tpu.checkpoint.torch_export import flax_to_torch, save_clip_checkpoint
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.models.cnn import build_cnn as jax_build_cnn
from simseg_tpu.models.linear_prob import LinearProbModel as JaxLinearProbModel
from simseg_tpu.models.linear_prob import build_linear_prob_model as jax_build_probe
from simseg_tpu.ops.grad_rev import grad_reverse as jax_grad_reverse
from simseg_tpu.tasks.linear_prob.config import task_cfg_init_fn as jax_probe_init
from simseg_tpu.tasks.seg_eval import image_patch_stride as jax_patch_stride
from simseg_tpu_torch.checkpoint.convert import (flax_param_path,
                                                 flax_params_to_state_dict)
from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.core.lr_schedule import build_schedule
from simseg_tpu_torch.core.optim import LARS, build_optimizer
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.models.cnn import build_cnn
from simseg_tpu_torch.models.layers import BatchNorm, same_pad
from simseg_tpu_torch.models.linear_prob import (LinearProbModel,
                                                 build_linear_prob_model)
from simseg_tpu_torch.ops.grad_rev import grad_reverse
from simseg_tpu_torch.tasks.linear_prob.config import task_cfg_init_fn
from simseg_tpu_torch.tasks.seg_eval import image_patch_stride
from tests.test_models import tiny_clip

torch.set_num_threads(2)

IMG = "image_encoder.model.model."
EFFNET_ARCH = {"stages": ((1, 8, 1, 1, 3), (6, 16, 2, 2, 3)),
               "stem_chs": 8, "head_chs": 32}
# name -> (tag, arch)
TOWERS = {
    "resnet_test": ("resnet_test", None),
    "resnet_basic_test": ("resnet_basic_test", None),
    "convnext_test": ("convnext_test", None),
    "efficientnet_arch": ("efficientnet_two_stage", EFFNET_ARCH),
}
BN_TOWERS = ("resnet_test", "resnet_basic_test", "efficientnet_arch")


def _perturbed(variables, seed=0):
    """Initial variables moved off their constants: parameters by a little
    noise, BN means about 0 and variances about 1.3."""
    rng = np.random.default_rng(seed)
    out = {"params": jax.tree.map(
        lambda a: np.asarray(a + rng.normal(size=a.shape) * 0.05, np.float32),
        variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(np.asarray, variables["batch_stats"])
        stats = out["batch_stats"]

        def walk(node):
            for k, v in node.items():
                if k == "mean":
                    node[k] = rng.normal(size=v.shape).astype(np.float32) * 0.1
                elif k == "var":
                    node[k] = (1.0 + np.abs(rng.normal(size=v.shape)) * 0.5
                               ).astype(np.float32)
                else:
                    walk(v)
        walk(stats)
    return out


def _tower_pair(name, size=32, seed=0):
    """(JAX tower, its perturbed variables, the port tower with them)."""
    tag, arch = TOWERS[name]
    jm = jax_build_cnn(tag, arch=arch)
    variables = _perturbed(jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, size, size, 3)))), seed)
    scoped = {"params": {"image_encoder": variables["params"]}}
    if "batch_stats" in variables:
        scoped["batch_stats"] = {"image_encoder": variables["batch_stats"]}
    port = build_cnn(tag, arch)
    port.load_state_dict({k[len(IMG):]: v for k, v in
                          flax_params_to_state_dict(scoped).items()}, strict=True)
    return jm, variables, port


def _images(n, size, seed=1):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name,size", [(n, s) for n in TOWERS
                                       for s in (32, 37 if n != "convnext_test"
                                                 else 42)])
def test_tower_map_matches_jax(name, size):
    jm, variables, port = _tower_pair(name, size)
    x = _images(2, size)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert want.shape[1] == -(-size // port.patch_size)


def test_same_pad_keeps_the_rows_torch_would_drop():
    """At 42 px the stem (4x4 / 4) pads (1, 1) as flax's SAME does: 11 rows
    where torch's padding=0 gives 10."""
    x = torch.zeros(1, 1, 42, 42)
    assert same_pad(x, 4, 4).shape[-1] == 44
    assert same_pad(torch.zeros(1, 1, 40, 40), 4, 4).shape[-1] == 40
    assert same_pad(torch.zeros(1, 1, 11, 11), 2, 2).shape[-1] == 12


def _live_bn_stats(name):
    jm, variables, port = _tower_pair(name, 32)
    x1, x2 = _images(4, 32, seed=2), _images(4, 32, seed=3)
    for x in (x1, x2):
        out, upd = jm.apply(variables, jnp.asarray(x), train_bn=True,
                            mutable=["batch_stats"])
        variables = {**variables, "batch_stats": upd["batch_stats"]}
        got = port.train()(torch.from_numpy(x), train_bn=True)
    want = flax_params_to_state_dict(
        {"params": {}, "batch_stats": {"image_encoder": variables["batch_stats"]}})
    return port, want, np.asarray(out), got.detach().numpy()


@pytest.mark.parametrize("name", BN_TOWERS)
def test_live_bn_running_stats_match_flax(name):
    port, want, out, got = _live_bn_stats(name)
    assert np.abs(got - out).max() <= 1e-4 * np.abs(out).max()
    n = 0
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            ref = want[IMG + key].numpy()
            np.testing.assert_allclose(value.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=key)
            n += 1
    assert n > 0


def test_pytorch_unbiased_update_fails_the_stats_bar():
    """The planted fault: PyTorch's training-mode update (unbiased variance,
    momentum 0.1) on the same batch misses flax's running variance by the
    factor n / (n - 1), far beyond rtol 1e-5."""
    x = torch.from_numpy(_images(2, 4)).permute(0, 3, 1, 2).contiguous()
    bn = BatchNorm(3)
    bn(x, train_bn=True)
    mean, var = torch.zeros(3), torch.ones(3)
    F.batch_norm(x, mean, var, None, None, True, 0.1, 1e-5)
    np.testing.assert_allclose(mean.numpy(), bn.running_mean.numpy(), rtol=1e-5)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(var.numpy(), bn.running_var.numpy(),
                                   rtol=1e-5)


# ------------------------------------------------------------------- LARS

def _probe_trees(argv):
    ours = update_cfg(task_cfg_init_fn, None, argv, target=new_base_cfg())
    ref = jax_update_cfg(jax_probe_init, None, argv, target=jax_new_base_cfg())
    return ours, ref


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_lars_matches_optax_across_the_warmup(weight_decay):
    """Five steps of the YAML's LARS (lr 6.4, cosine warmup over 2 of 20
    steps) on a ResNet probe with a trainable tower and a frozen block;
    the zero-initialised classifier bias takes its first step at trust
    ratio 1."""
    argv = ["model.image_encoder.tag=resnet_test",
            "model.image_encoder.trainable=true",
            "model.classifier.num_classes=4", "transforms.input_size=32",
            "dist.bf16=false",
            f"optim.param={{'momentum': 0.9, 'weight_decay': {weight_decay}, "
            "'trust_coefficient': 0.001}"]
    ours_cfg, ref_cfg = _probe_trees(argv)
    frozen = (r"^params/image_encoder/layer1_0/",)
    jm = jax_build_probe(ref_cfg)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)), "label": jnp.zeros((1,), jnp.int32)}))
    variables = _perturbed(variables)
    variables["params"]["classifier"]["bias"] = np.zeros(4, np.float32)
    port = build_linear_prob_model(ours_cfg)
    port.load_state_dict(flax_params_to_state_dict(variables), strict=True)
    tx, set_lr = jax_build_optimizer(ref_cfg, variables,
                                     frozen_patterns=frozen + (r"^batch_stats/",))
    opt = build_optimizer(ours_cfg, port, frozen_patterns=frozen)
    assert isinstance(opt.base, LARS)
    schedule = build_schedule(ours_cfg, 20)
    frozen_before = port.state_dict()[
        IMG + "layer1.0.conv1.weight"].numpy().copy()
    state = tx.init(variables)
    named = dict(port.named_parameters())
    rng = np.random.default_rng(4)
    for step in range(5):
        grads = jax.tree.map(
            lambda p: np.asarray(rng.normal(size=p.shape) * 0.1, np.float32),
            variables)
        lr = schedule(step)
        state = set_lr(state, lr)
        updates, state = tx.update(grads, state, variables)
        variables = optax.apply_updates(variables, updates)
        for key, g in flax_params_to_state_dict(
                {"params": grads["params"]}).items():
            named[key].grad = g
        opt.set_lr(lr)
        opt.step()
    assert schedule(1) < schedule(2) and schedule(4) < schedule(2)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, variables))
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(
        named[IMG + "layer1.0.conv1.weight"].detach().numpy(), frozen_before)


# ------------------------------------------------------------ checkpoints

CLIP_TOWERS = ("resnet_test", "convnext_test", "efficientnet_test")


def _clip_pair(tag, seed=0):
    jm = tiny_clip(image_tag=tag)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, 8), jnp.int32),
             "attention_mask": jnp.ones((1, 8), jnp.int32)}
    variables = _perturbed(jax.tree.map(np.asarray,
                                        jm.init(jax.random.key(seed), dummy)))
    port = CLIPModel(image_tag=tag, img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3)
    return jm, variables, port


@pytest.mark.parametrize("tag", CLIP_TOWERS)
def test_checkpoint_both_directions_bit_equal(tag, tmp_path):
    jm, variables, port = _clip_pair(tag)
    # flax -> torch: the port's converter against JAX's export
    ours = flax_params_to_state_dict(variables)
    ref, _ = flax_to_torch(variables, strict=True)
    assert set(ours) == set(ref)
    for key, value in ours.items():
        assert np.array_equal(value.numpy(), ref[key]), key
    port.load_state_dict(ours, strict=True)
    # torch -> model: a reference-layout .pth through both loaders
    path = str(tmp_path / "clip.pth")
    save_clip_checkpoint(path, variables)
    fresh = _clip_pair(tag, seed=1)[2]
    report = load_clip_checkpoint(path, fresh, strict=True)
    assert not report["missing"] and not report["unexpected"]
    template = jm.init(jax.random.key(2), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 8), jnp.int32),
        "attention_mask": jnp.ones((1, 8), jnp.int32)})
    loaded, jreport = jax_load_clip(path, template, strict=True)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, loaded))
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key].to(value.dtype)), key


@pytest.mark.parametrize("tag", CLIP_TOWERS)
def test_flax_param_path_inverts_the_cnn_layouts(tag):
    _, variables, port = _clip_pair(tag)
    for name, _ in port.named_parameters():
        path = flax_param_path(name).split("/")
        node = variables
        for k in path:
            node = node[k]
        single = {"params": {}}
        leaf = single["params"]
        for k in path[1:-1]:
            leaf = leaf.setdefault(k, {})
        leaf[path[-1]] = node
        assert list(flax_params_to_state_dict(single)) == [name]


# ------------------------------------------------------------ grid step

@pytest.mark.parametrize("tag", ["vit_base_patch16_224", "vit_test",
                                 "resnet50", "resnet18", "convnext_tiny",
                                 "efficientnet_b0"])
def test_image_patch_stride_matches_jax(tag):
    jm = tiny_clip(image_tag=tag)
    port = CLIPModel(image_tag=tag, img_size=32 if "test" in tag else 224,
                     text_tag="bert_test", projection_dim=16, image_k=3)
    assert image_patch_stride(port) == jax_patch_stride(jm)


@pytest.mark.parametrize("tag", ["resnet_test", "convnext_test",
                                 "efficientnet_test"])
def test_image_patch_stride_of_a_two_stage_tower_is_its_map_step(tag):
    """JAX says 32 for any CNN; the two-stage test towers' maps step 8
    (EfficientNet's test table 4), which the port's grid follows."""
    port = CLIPModel(image_tag=tag, img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3).eval()
    tokens = port.forward_image_tokens(torch.zeros(1, 64, 64, 3))
    assert tokens.shape[1] == (64 // image_patch_stride(port)) ** 2
    assert jax_patch_stride(tiny_clip(image_tag=tag)) == 32


# ------------------------------------------------------------- refusals

def _message(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("tag,arch", [("densenet121", None),
                                      ("tf_efficientnet_b0", None),
                                      ("efficientnet_b9", None),
                                      ("convnext_huge", {"depths": (1,)}),
                                      ("resnet50", {"bogus": 1})])
def test_unknown_cnn_tags_refused_with_jax_messages(tag, arch):
    ours = _message(build_cnn, tag, arch)
    ref = _message(jax_build_cnn, tag, arch=arch)
    assert ours[0] == ref[0]
    if ours[0] is KeyError:
        assert ours[1] == ref[1]


@pytest.mark.parametrize("arch", ["{'quant': 'int8'}", "{'moe_experts': 4}"])
def test_trainable_probe_refusals_match_jax(arch):
    argv = ["model.image_encoder.tag=vit_test",
            "model.image_encoder.trainable=true", f"model.image_encoder.arch={arch}"]
    ours_cfg, ref_cfg = _probe_trees(argv)
    assert (_message(build_linear_prob_model, ours_cfg)
            == _message(jax_build_probe, ref_cfg))


def test_frozen_quantised_probe_builds():
    ours_cfg, ref_cfg = _probe_trees(["model.image_encoder.tag=vit_test",
                                      "model.image_encoder.arch={'quant': 'int8'}",
                                      "transforms.input_size=32"])
    assert isinstance(build_linear_prob_model(ours_cfg), LinearProbModel)
    assert isinstance(jax_build_probe(ref_cfg), JaxLinearProbModel)


def test_grad_reverse_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    jg = jax.grad(lambda v: jnp.sum(jax_grad_reverse(v, 0.5) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = grad_reverse(t, 0.5)
    assert torch.equal(y.detach(), t.detach())
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
