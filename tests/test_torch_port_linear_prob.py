"""PyTorch port (simseg_tpu_torch): the linear probe against the JAX
package on the CPU — ``linear_prob_loss_fn``, the probe's logits, and the
entry point ``tasks/linear_prob/train.main(argv)`` beside JAX's
``build_imagenet_dataloaders`` + ``LinearProbRunner`` in process on a toy
ImageFolder (three classes of JPEGs at mixed sizes), with the task's
default optimizer (LARS, lr 6.4, cosine warmup) and the YAML's transforms
(``random_resize_crop`` + ``random_flip``, bicubic resize + center crop)
under the same ``random.seed``; then the launcher over two gloo ranks
against one process.

JAX's initial parameters reach the port as a ``.pth`` through
``ckpt.external_resume`` (the probe's tower and classifier).

Bars: loss within rtol 1e-5 and top-1 / top-5 equal (with and without
smoothing and mixup); per-step losses within rtol 1e-5 of JAX's runner,
final parameters within rtol 2e-4 / atol 1e-6, each validation's top-1 /
top-5 equal; two ranks' final parameters within rtol 1e-5 / atol 1e-7 of
one process's, accuracies equal.
"""

import os
import random
import subprocess
import sys
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import simseg_tpu_torch.core.runner as port_runner
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.core.hooks import Hook as JaxHook
from simseg_tpu.core.hooks import Priority as JaxPriority
from simseg_tpu.core.runner import LinearProbRunner as JaxRunner
from simseg_tpu.data.datasets import build_imagenet_dataloaders as jax_loaders
from simseg_tpu.models.linear_prob import build_linear_prob_model as jax_build_probe
from simseg_tpu.models.linear_prob import linear_prob_loss_fn as jax_loss_fn
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.tasks.linear_prob.config import task_cfg_init_fn as jax_init
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.checkpoint.native import load_params
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.models.linear_prob import (build_linear_prob_model,
                                                 linear_prob_loss_fn, top_k_ids)
from simseg_tpu_torch.tasks.linear_prob import train as port_train
from simseg_tpu_torch.tasks.linear_prob.config import task_cfg_init_fn
from tests.test_torch_port_cnn import _perturbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["seed=0", "dist.bf16=false", "model.image_encoder.tag=vit_test",
        "model.classifier.num_classes=3", "transforms.input_size=32",
        "data.batch_size=8", "data.batch_size_val=8", "data.num_workers=1",
        "data.native_decode=False", "ckpt.step_interval=-1",
        "log.interval_train=1"]
YAML_TRANSFORMS = ["transforms.random_resize_crop.size=32",
                   "transforms.resize_bicubic.size=36",
                   "transforms.center_crop.size=32"]


def _trees(argv):
    ours = update_cfg(task_cfg_init_fn, None, argv, target=new_base_cfg())
    ref = jax_update_cfg(jax_init, None, argv, target=jax_new_base_cfg())
    return ours, ref


def _probe_pair(argv, seed=0):
    """(JAX probe, its perturbed variables as numpy, the port probe)."""
    ours_cfg, ref_cfg = _trees(BASE + argv)
    jm = jax_build_probe(ref_cfg)
    variables = _perturbed(jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), {"image": jnp.zeros((1, 32, 32, 3)),
                               "label": jnp.zeros((1,), jnp.int32)})), seed)
    port = build_linear_prob_model(ours_cfg)
    port.load_state_dict(flax_params_to_state_dict(variables), strict=True)
    return jm, variables, port


# ------------------------------------------------------------- the loss

LOSSES = {"plain": (0.0, False), "smoothing": (0.1, False),
          "mixup": (0.0, True), "mixup_smoothing": (0.1, True)}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_fn_matches_jax(name):
    smoothing, soft = LOSSES[name]
    jm, variables, port = _probe_pair([])
    rng = np.random.default_rng(3)
    images = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6)
    if soft:
        onehot = np.eye(3, dtype=np.float32)[labels]
        onehot = onehot * (1 - smoothing) + smoothing / 3
        labels = 0.3 * onehot + 0.7 * onehot[::-1]
    jloss, jm_ = jax_loss_fn(jm, variables, {"image": jnp.asarray(images),
                                             "label": jnp.asarray(labels)},
                             smoothing=smoothing, soft_targets=soft)
    loss, metrics = linear_prob_loss_fn(
        port, {"image": torch.from_numpy(images),
               "label": torch.from_numpy(np.asarray(labels))},
        smoothing=smoothing, soft_targets=soft)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(metrics["acc1"]) == float(jm_["acc1"])
    assert float(metrics["acc5"]) == float(jm_["acc5"])


def test_top_k_ties_to_the_lower_index_as_lax_top_k():
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 2.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), 5)[1])
    np.testing.assert_array_equal(top_k_ids(torch.from_numpy(logits), 5), want)


@pytest.mark.parametrize("argv", [[], ["model.image_encoder.vit.only_cls_token=false"],
                                  ["model.image_encoder.tag=resnet_test"]],
                         ids=["vit_cls", "vit_patch_mean", "resnet_test"])
def test_probe_logits_match_jax(argv):
    jm, variables, port = _probe_pair(argv)
    images = np.random.default_rng(5).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(variables, {"image": jnp.asarray(images)}))
    got = port({"image": torch.from_numpy(images)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_frozen_tower_keeps_no_graph_and_no_stats():
    """In train mode a frozen CNN tower runs without a graph and on its
    running statistics, which stay bit-equal."""
    _, _, port = _probe_pair(["model.image_encoder.tag=resnet_test"])
    before = {k: v.clone() for k, v in port.state_dict().items()
              if "running" in k}
    port.train()
    images = torch.randn(4, 32, 32, 3)
    feats = port.forward_image_feature(images)
    assert not feats.requires_grad
    loss = port({"image": images}).sum()
    loss.backward()
    assert all(p.grad is None for n, p in port.named_parameters()
               if n.startswith("image_encoder"))
    assert port.classifier.weight.grad is not None
    for k, v in port.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k
    assert port.image_tower.training


# ------------------------------------------------------ the entry point

def write_folders(root, classes=3, train=8, val=4, seed=0):
    """``root/{train,val}/class_k/i.jpg`` at mixed sizes."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", train), ("val", val)):
        for c in range(classes):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (40, 48) if i % 2 else (52, 36)
                arr = rng.integers(0, 255, (h, w, 3), np.uint8)
                arr[..., c] = np.clip(arr[..., c].astype(int) + 60, 0, 255)
                Image.fromarray(arr).save(d / f"{i}.jpg")


class _JaxRecord(JaxHook):
    def __init__(self):
        self.losses, self.evals = [], []

    def after_train_step(self, runner):
        self.losses.append(float(runner.outputs["loss"]))

    def after_val_epoch(self, runner):
        self.evals.append(dict(runner.state.linear_eval))


def _jax_run(tmp_path, argv, variables):
    cfg = jax_update_cfg(jax_init, None, argv + [
        f"data.data_path={tmp_path}/data/", f"ckpt.dir={tmp_path}/jax"],
        target=jax_new_base_cfg())
    random.seed(0)
    np.random.seed(0)
    # one device: JAX's mixup flips within each device's block of the
    # batch, and one port process holds the whole batch
    runner = JaxRunner(cfg, jax_build_probe(cfg), jax_loaders(cfg),
                       params=variables, mesh=jax_make_mesh(jax.devices()[:1]))
    record = _JaxRecord()
    runner.register_hook(record, JaxPriority.LOWEST)
    runner.run()
    record.final = jax.tree.map(np.asarray, runner.train_state.params)
    return record


def _port_run(tmp_path, argv):
    losses, evals = [], []
    inner = port_runner.LinearProbRunner.batch_processor
    after_val = port_runner.LinearProbRunner._validate

    def keep(runner, batch, device_batch=None):
        out = inner(runner, batch, device_batch)
        losses.append(float(out["loss"]))
        return out

    def keep_eval(runner):
        after_val(runner)
        evals.append(dict(runner.state.linear_eval))

    random.seed(0)
    np.random.seed(0)
    with unittest.mock.patch.object(port_runner.LinearProbRunner,
                                    "batch_processor", keep), \
            unittest.mock.patch.object(port_runner.LinearProbRunner,
                                       "_validate", keep_eval):
        runner = port_train.main(
            ["--cfg", "", "--device", "cpu", f"data.data_path={tmp_path}/data/",
             f"ckpt.dir={tmp_path}/port",
             f"ckpt.external_resume={tmp_path}/init.pth"] + argv)
    return runner, losses, evals


# name -> (run overrides, tower overrides)
RUNS = {
    "vit_yaml_transforms": (["epoch=2"], []),
    "mixup_smoothing": (["epoch=1", "mixup.enable=True", "mixup.alpha=0.4",
                         "loss.smoothing=0.1"], []),
    "resnet_tower": (["epoch=1"], ["model.image_encoder.tag=resnet_test"]),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_entry_point_matches_jax_runner(tmp_path, name):
    run, tower = RUNS[name]
    argv = BASE + YAML_TRANSFORMS + run + tower
    write_folders(tmp_path / "data")
    _, variables, _ = _probe_pair(tower)
    torch.save({"state_dict": flax_params_to_state_dict(variables)},
               tmp_path / "init.pth")
    want = _jax_run(tmp_path, argv, variables)
    runner, losses, evals = _port_run(tmp_path, argv)
    assert runner.step == len(want.losses) == len(losses) > 2
    np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
    assert evals == want.evals and len(evals) == runner.epoch
    ref = flax_params_to_state_dict(want.final)
    for key, value in runner.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[key].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=key)


def test_launch_over_two_gloo_ranks_equals_one_process(tmp_path):
    """``python -m simseg_tpu_torch.launch --task linear_prob
    --nproc_per_node 2 --device cpu``: its final parameters and accuracies
    against ``main(argv)`` in one process. The train images are resized,
    not randomly cropped: each rank would draw its crops from its own
    process's generator."""
    argv = BASE + ["epoch=2", "transforms.train_transforms=[resize]",
                   "transforms.resize.size=32",
                   "transforms.resize_bicubic.size=36",
                   "transforms.center_crop.size=32"]
    write_folders(tmp_path / "data")
    _, variables, _ = _probe_pair([])
    torch.save({"state_dict": flax_params_to_state_dict(variables)},
               tmp_path / "init.pth")
    single, _, evals = _port_run(tmp_path, argv)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "simseg_tpu_torch.launch", "--task",
         "linear_prob", "--nproc_per_node", "2", "--cfg", "", "--device",
         "cpu", f"data.data_path={tmp_path}/data/", f"ckpt.dir={tmp_path}/w2",
         f"ckpt.external_resume={tmp_path}/init.pth"] + argv,
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    model = build_linear_prob_model(single.cfg)
    load_params(str(tmp_path / "w2" / single.cfg.data.exp_name / "epoch_002"),
                model)
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(),
                                   single.model.state_dict()[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    last = evals[-1]
    assert (f"[linear eval] top-1: {last['acc1']:.4f} top-5: "
            f"{last['acc5']:.4f}") in r.stdout
