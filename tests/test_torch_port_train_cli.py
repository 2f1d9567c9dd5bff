"""PyTorch port (simseg_tpu_torch): the pretraining entry point end to end
against the JAX package's — ``tasks/clip/train.main(argv)`` on the CPU
beside JAX's ``build_clip_dataloaders`` + ``CLIPRunner`` in process
(``tests/test_runner.py``'s way), on the same CSV set, seeds and weights.

The config is ``tests/test_train_cli.py:CLIP_YAML`` (vit_test and
bert_test towers, 32 px, batch 8) with JAX's pretraining transforms
``[random_resize_crop, autoaug]``, float32 (``dist.bf16=False``), one
decode thread, 3 steps and retrieval validation after each step. JAX's
initial parameters reach the port as a ``.pth`` through
``ckpt.external_resume``.

Bars: every train batch bit-equal (images, token ids); per-step losses
within 1e-4 relative (float32 sums in another order, through three Adam
steps); each validation's R@1/5/10 and RSUM within 1e-6.
"""

import random
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu_torch.core.runner as port_runner
import simseg_tpu_torch.core.train_hooks as port_hooks
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.core.hooks import Hook as JaxHook
from simseg_tpu.core.hooks import Priority as JaxPriority
from simseg_tpu.core.runner import CLIPRunner as JaxRunner
from simseg_tpu.data.datasets import build_clip_dataloaders as jax_build_loaders
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from simseg_tpu.models.clip import build_clip_model as jax_build_clip_model
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu.tasks.clip.config import update_clip_config as jax_update_clip_config
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.data.tokenizer import make_test_vocab
from simseg_tpu_torch.tasks.clip import train as port_train
from tests.test_torch_port_pair_data import WORDS, write_pair_set
from tests.test_torch_port_train import _key_bias
from tests.test_train_cli import CLIP_YAML

torch.set_num_threads(2)

STEPS = 3
OVERRIDES = ["transforms.train_transforms=[random_resize_crop,autoaug]",
             "transforms.random_resize_crop.size=32", "data.native_decode=False",
             "data.train_name=[pairs]", "data.valid_name=[pairs]",
             f"data.train_steps={STEPS}", "runner.val_interval_steps=1",
             "runner.stable_random=none", "log.interval_train=1"]


class _JaxRecord(JaxHook):
    def __init__(self):
        self.losses, self.summaries = [], []

    def after_train_step(self, runner):
        self.losses.append(float(runner.outputs["loss"]))

    def after_val_epoch(self, runner):
        self.summaries.append(dict(runner.state.retrieval_summary))


def _jax_run(tmp_path, yaml, vocab, overrides):
    """JAX's run, its batches and records, and its initial parameters."""
    cfg = jax_update_cfg(jax_task_cfg_init_fn, yaml,
                         overrides + [f"data.data_path={tmp_path}/data/",
                                      f"ckpt.dir={tmp_path}/jax"],
                         preprocess_fn=jax_update_clip_config,
                         target=jax_new_base_cfg())
    model = jax_build_clip_model(cfg)
    # on the host: the runner's step donates its device copy
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32)}))
    batches = []
    inner = JaxRunner.batch_processor

    def keep(runner, batch, device_batch=None):
        batches.append(batch)
        return inner(runner, batch, device_batch)

    random.seed(0)
    np.random.seed(0)
    loaders = jax_build_loaders(cfg, tokenizer=JaxTokenizer(dict(vocab)))
    with unittest.mock.patch.object(JaxRunner, "batch_processor", keep):
        runner = JaxRunner(cfg, model, loaders, params=params)
        record = _JaxRecord()
        runner.register_hook(record, JaxPriority.LOWEST)
        runner.run()
    record.final_params = jax.tree.map(np.asarray, runner.train_state.params)
    return batches, record, params


def _port_run(tmp_path, yaml, overrides):
    """The port's ``main(argv)`` on the CPU from JAX's initial parameters:
    (runner, batches, losses, validation tables)."""
    batches, losses, summaries = [], [], []
    inner = port_runner.CLIPRunner.batch_processor
    after_val = port_hooks.RetrievalEvalHook.after_val_epoch

    def keep(runner, batch, device_batch=None):
        batches.append(batch)
        out = inner(runner, batch, device_batch)
        losses.append(float(out["loss"]))
        return out

    def keep_summary(hook, runner):
        after_val(hook, runner)
        summaries.append(dict(runner.state.retrieval_summary))

    random.seed(0)
    np.random.seed(0)
    with unittest.mock.patch.object(port_runner.CLIPRunner, "batch_processor",
                                    keep), \
            unittest.mock.patch.object(port_hooks.RetrievalEvalHook,
                                       "after_val_epoch", keep_summary):
        runner = port_train.main(
            ["--cfg", yaml, "--vocab_file", str(tmp_path / "vocab.txt"),
             "--device", "cpu", f"data.data_path={tmp_path}/data/",
             f"ckpt.dir={tmp_path}/port",
             f"ckpt.external_resume={tmp_path}/init.pth"] + overrides)
    return runner, batches, losses, summaries


def _run_both(tmp_path, overrides):
    yaml = tmp_path / "clip.yaml"
    yaml.write_text(CLIP_YAML)
    vocab = make_test_vocab(WORDS)
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    want_batches, want, params = _jax_run(tmp_path, str(yaml), vocab, overrides)
    torch.save({"state_dict": flax_params_to_state_dict(
        {"params": params["params"]})}, tmp_path / "init.pth")
    runner, batches, losses, summaries = _port_run(tmp_path, str(yaml), overrides)
    assert runner.step == STEPS and len(batches) == len(want_batches) == STEPS
    for got, ref in zip(batches, want_batches):
        np.testing.assert_array_equal(got["image"].numpy(), ref["image"])
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(losses, want.losses, rtol=1e-4)
    return summaries, want.summaries


def test_train_main_matches_jax(tmp_path):
    """JAX's pretraining recipe in shuffle mode, validating after each
    step."""
    write_pair_set(tmp_path / "data", "pairs", 28, 16, seed=12)
    summaries, want = _run_both(tmp_path, OVERRIDES)
    assert len(summaries) == len(want) == STEPS
    for got, ref in zip(summaries, want):
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k])), k


MODES = {
    "sequential": ["transforms.train_transforms=[random_resize_crop,autoaug]"],
    # every loader's producer draws at once in debias mode (the module-level
    # random interleaves by thread timing in both packages): ops without
    # draws
    "debias": ["transforms.train_transforms=[resize]"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_train_main_modes_match_jax(tmp_path, mode):
    """The other two train modes over two sets (9 and 20 rows: the first
    runs out within the 3 steps), no validation."""
    write_pair_set(tmp_path / "data", "a", 9, 0, seed=13)
    write_pair_set(tmp_path / "data", "b", 20, 0, seed=14)
    overrides = [o for o in OVERRIDES if not o.startswith(
        ("transforms.train_transforms", "data.train_name"))]
    _run_both(tmp_path, overrides + MODES[mode] + [
        f"data.train_type={mode}", "data.train_name=[a,b]",
        "data.enable_valid=False"])


def test_train_main_bsgs_matches_jax(tmp_path):
    """``runner.name=clip_bsgs``: batch 8 in micro-batches of 4, 2 steps, no
    validation. Losses within 1e-4 relative and parameters within 1e-5 of
    JAX's runner; the key biases, whose gradient is zero in exact
    arithmetic, within the 2 x lr a step that Adam gives either side's
    float32 noise there."""
    write_pair_set(tmp_path / "data", "pairs", 20, 0, seed=15)
    overrides = [o for o in OVERRIDES if not o.startswith("data.train_steps")]
    overrides += ["runner.name=clip_bsgs", "data.batch_size_train=4",
                  "data.train_steps=2", "data.enable_valid=False"]
    yaml = tmp_path / "clip.yaml"
    yaml.write_text(CLIP_YAML)
    vocab = make_test_vocab(WORDS)
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    _, want, params = _jax_run(tmp_path, str(yaml), vocab, overrides)
    torch.save({"state_dict": flax_params_to_state_dict(
        {"params": params["params"]})}, tmp_path / "init.pth")
    runner, _, losses, _ = _port_run(tmp_path, str(yaml), overrides)
    assert runner.step == 2 and len(want.losses) == 2
    assert "make_bsgs_train_step" in runner._step_fn.__qualname__
    np.testing.assert_allclose(losses, want.losses, rtol=1e-4)
    ref = flax_params_to_state_dict(want.final_params)
    drift = 2 * 2 * 1e-3
    for key, value in runner.model.state_dict().items():
        a, b = value.numpy(), ref[key].numpy()
        keys = _key_bias(key, a.size)
        if keys is not None:
            assert np.all(np.abs(a[keys] - b[keys]) <= drift), key
            a, b = np.delete(a, keys), np.delete(b, keys)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)


# settings JAX acts on that the port has not ported: each refused by name,
# with its ROADMAP item, where the runner builds its step (the MoE towers
# where the towers are built); ``profile`` is no key of the config files,
# JAX's users set it on the tree, as the case does
UNPORTED = {
    "dist.pp_size=2": "item 13", "dist.pp_micro=8": "item 13",
    "dist.moe_ep=True": "item 13",
    "model.image_encoder.arch={'moe_experts': 4}": "item 13",
    "model.text_encoder.arch={'moe_experts': 4}": "item 13",
    "ckpt.backend=orbax": "item 11", "wandb.enable=True": "item 11",
    "profile": "item 11",
}


@pytest.fixture(scope="module")
def refusal_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("refusals")
    write_pair_set(root / "data", "pairs", 8, 0, seed=16)
    (root / "clip.yaml").write_text(CLIP_YAML)
    (root / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    return root


@pytest.mark.parametrize("setting", list(UNPORTED))
def test_train_main_refuses_unported_settings(refusal_fixture, setting):
    root = refusal_fixture
    argv = ["--cfg", str(root / "clip.yaml"), "--vocab_file",
            str(root / "vocab.txt"), "--device", "cpu",
            f"data.data_path={root}/data/", f"ckpt.dir={root}/out",
            "data.train_name=[pairs]", "data.enable_valid=False",
            "data.native_decode=False", "data.train_steps=1"]
    init = port_train.task_cfg_init_fn
    if setting == "profile":
        def init_with_profile(cfg):
            init(cfg)
            cfg.profile = {"start_step": 1, "num_steps": 1, "dir": str(root)}
    else:
        argv.append(setting)
        init_with_profile = init
    with unittest.mock.patch.object(port_train, "task_cfg_init_fn",
                                    init_with_profile), \
            pytest.raises(NotImplementedError, match=UNPORTED[setting]):
        port_train.main(argv)


# the sharded legs, ported: main(argv) trains with each, over two gloo
# ranks (one model group of 2, or 2 data ranks)
SHARDED = {
    "dist.tp_size=2": ["dist.tp_size=2"],
    "dist.tp_size=2 dist.sp=True": ["dist.tp_size=2", "dist.sp=True"],
    "dist.zero1=True": ["dist.zero1=True"],
    "dist.fsdp=True": ["dist.fsdp=True"],
    "clip_bsgs dist.tp_size=2 dist.zero1=True": [
        "runner.name=clip_bsgs", "data.batch_size_train=4", "dist.tp_size=2",
        "dist.zero1=True"],
}

SHARDED_ENTRY = r'''
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
import datetime
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
from simseg_tpu_torch.parallel.sharding import full_state_dict
from simseg_tpu_torch.tasks.clip import train
base, settings = json.loads(os.environ["ARGS"])
out = {}
for name, extra in settings.items():
    runner = train.main(base + extra + [f"ckpt.dir={os.environ['OUT']}/{len(out)}"])
    full = full_state_dict(runner.model)
    out[name] = {"step": runner.step, "loss": float(runner.outputs["loss"]),
                 "plan": getattr(runner.model, "shard_plan", None) is not None,
                 "sum": float(sum(v.double().sum() for v in full.values()))}
if dist.get_rank() == 0:
    json.dump(out, open(os.path.join(os.environ["OUT"], "sharded.json"), "w"))
'''


@pytest.fixture(scope="module")
def sharded_runs(refusal_fixture, tmp_path_factory):
    import json

    from tests.test_torch_port_distributed import run_world

    root = refusal_fixture
    out = tmp_path_factory.mktemp("sharded")
    base = ["--cfg", str(root / "clip.yaml"), "--vocab_file",
            str(root / "vocab.txt"), "--device", "cpu",
            f"data.data_path={root}/data/", "data.train_name=[pairs]",
            "data.enable_valid=False", "data.native_decode=False",
            "data.train_steps=1", "ckpt.step_interval=-1"]
    run_world(2, SHARDED_ENTRY, {"OUT": str(out),
                                 "ARGS": json.dumps([base, SHARDED])})
    return json.loads((out / "sharded.json").read_text())


@pytest.mark.parametrize("setting", list(SHARDED))
def test_train_main_trains_with_sharded_setting(sharded_runs, setting):
    """Each setting that was refused before its port trains a step through
    ``main(argv)`` over two ranks, on a sharded model, to a finite loss."""
    run = sharded_runs[setting]
    assert run["step"] == 1 and run["plan"]
    assert np.isfinite(run["loss"]) and np.isfinite(run["sum"])


def test_train_main_sp_without_tp_raises_jax_value_error(refusal_fixture):
    """``dist.sp=True`` alone: JAX's ValueError (the token dim shards over
    the tensor-parallel axis)."""
    root = refusal_fixture
    argv = ["--cfg", str(root / "clip.yaml"), "--vocab_file",
            str(root / "vocab.txt"), "--device", "cpu",
            f"data.data_path={root}/data/", f"ckpt.dir={root}/sp",
            "data.train_name=[pairs]", "data.enable_valid=False",
            "data.native_decode=False", "data.train_steps=1", "dist.sp=True"]
    with pytest.raises(ValueError, match="tp_size"):
        port_train.main(argv)
