"""PyTorch port (simseg_tpu_torch): the sharded-state legs, FSDP and
ZeRO-1 (``parallel/sharding.py``, ``core/optim.py``), alone, with tensor
parallelism, grouped negatives and BSGS, against JAX's step on the same
mesh (the worker and bars of ``tests/test_torch_port_tp.py``; ZeRO-1's
parameters within JAX's ``tests/test_zero1.py`` bar, rtol 2e-4, atol
1e-6); then what the sharded state does to checkpoints and the entry
point:

- ZeRO-1 over 2 data ranks bit-equal to the port's data-parallel step
  under AdamW (the whole gradient is summed, then sliced: AdamW is
  elementwise);
- a tp + ZeRO-1 run resumed halfway from its checkpoint bit-equal to the
  uninterrupted run (JAX ``tests/test_runner.py:252``);
- a tp = 2 checkpoint, written whole, loaded into a one-process run;
- ``tasks.clip.train.main(argv)`` over 2 gloo ranks with
  ``dist.tp_size=2`` against JAX's ``CLIPRunner`` on a tp = 2 mesh, on the
  same CSV set, seeds and weights (``tests/test_torch_port_train_cli.py``'s
  bars: batches bit-equal, losses 1e-4, R@k 1e-6);
- the launcher with tp = 2 and runner ``clip_bsgs`` against one process.
"""

import os
import random
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.core.hooks import Priority as JaxPriority
from simseg_tpu.core.runner import CLIPRunner as JaxRunner
from simseg_tpu.data.datasets import build_clip_dataloaders as jax_build_loaders
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from simseg_tpu.models.clip import build_clip_model as jax_build_clip_model
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu.tasks.clip.config import update_clip_config as jax_update_clip_config
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.checkpoint.native import load_checkpoint
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.data.tokenizer import make_test_vocab
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.tasks.clip import config as clip_config
from tests.test_torch_port_distributed import run_world
from tests.test_torch_port_pair_data import WORDS, write_pair_set
from tests.test_torch_port_tp import (SGD, TINY, assert_matches_jax,
                                      assert_ranks_agree, jax_run, make_batches,
                                      ranks_of, run_cases)
from tests.test_torch_port_train import _FIELDS
from tests.test_torch_port_train_cli import OVERRIDES, STEPS, _JaxRecord
from tests.test_train_cli import CLIP_YAML

torch.set_num_threads(2)

ADAMW = ["optim.name=torch.optim.AdamW",
         "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.001}",
         "optim.lr.name=constant_schedule", "optim.lr.init=1e-4"]

# name -> (world, global batch, steps, config overrides, JAX options or
# None: held against another case of the world)
CASES = {
    "fsdp": (2, 8, 3, SGD + ["dist.fsdp=True"], {"fsdp": True}),
    "zero1": (2, 8, 3, SGD + ["dist.zero1=True"], {"zero1": True}),
    "bsgs_fsdp": (2, 16, 2, SGD + ["dist.fsdp=True", "runner.name=clip_bsgs",
                                   "data.batch_size_train=4"],
                  {"fsdp": True, "bsgs": 4}),
    "dp_adamw": (2, 8, 3, ADAMW, None),
    "zero1_adamw": (2, 8, 3, ADAMW + ["dist.zero1=True"], None),
    "tp2_save": (2, 8, 2, ADAMW + ["dist.tp_size=2"], None),
    "tp2_group_zero1_w4": (4, 8, 3, SGD + ["dist.tp_size=2", "loss.group_size=1",
                                           "dist.zero1=True"],
                           {"tp": 2, "group": 1, "zero1": True}),
    "bsgs_tp2_zero1_w4": (4, 16, 2, SGD + ["dist.tp_size=2", "dist.zero1=True",
                                           "runner.name=clip_bsgs",
                                           "data.batch_size_train=4"],
                          {"tp": 2, "zero1": True, "bsgs": 4}),
    "resume_w4": (4, 8, 4, ADAMW + ["dist.tp_size=2", "dist.zero1=True"], None),
    "straight_w4": (4, 8, 4, ADAMW + ["dist.tp_size=2", "dist.zero1=True"], None),
}
SAME_DATA = {"zero1_adamw": "dp_adamw", "resume_w4": "straight_w4"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded{world}")
        batches, cases = {}, {}
        for name, (w, n, steps, argv, _) in CASES.items():
            if w != world:
                continue
            data = SAME_DATA.get(name, name)
            batches.update(make_batches(data, n, steps, 500 + len(data)))
            cases[name] = {"argv": TINY + argv + [f"data.batch_size={n}"],
                           "steps": steps, "data": data,
                           "save": name == "tp2_save",
                           "resume_at": 2 if name == "resume_w4" else None}
        flax_model, params = run_cases(tmp, world, cases, batches)
        out[world] = (tmp, flax_model, params, batches)
    return out


JAX_CASES = [k for k, v in CASES.items() if v[4] is not None]


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_leg_matches_jax_mesh(worlds, name):
    world, n, steps, _, opts = CASES[name]
    tmp, flax_model, params, batches = worlds[world]
    ranks = ranks_of(tmp, name, world)
    assert_ranks_agree(ranks)
    losses, want = jax_run(flax_model, params, batches, name, world, n, steps,
                           opts)
    assert_matches_jax(ranks[0], losses, want,
                       rtol=2e-4 if opts.get("zero1") else 3e-4)


def test_fsdp_shards_parameters_and_moments(worlds):
    """FSDP over 2 data ranks: the word embeddings (128 x 32) are split on
    their vocabulary dim, and so is their SGD momentum."""
    tmp = worlds[2][0]
    ranks = ranks_of(tmp, "fsdp", 2)
    key = "text_encoder.model.model.embeddings.word_embeddings.weight"
    assert ranks[0]["local"][key].shape == (64, 32)
    assert not torch.equal(ranks[0]["local"][key], ranks[1]["local"][key])
    assert ranks[0]["bytes"][0] < sum(4 * v.numel()
                                      for v in ranks[0]["full"].values())


def test_zero1_is_bit_equal_to_data_parallel(worlds):
    """ZeRO-1 under AdamW: losses and parameters bit-equal to the port's
    data-parallel step; the moments it saves (gathered whole) too; each
    rank held half of the large moments."""
    tmp = worlds[2][0]
    dp, z = ranks_of(tmp, "dp_adamw", 2), ranks_of(tmp, "zero1_adamw", 2)
    assert z[0]["losses"] == dp[0]["losses"]
    for k, v in dp[0]["full"].items():
        assert torch.equal(v, z[0]["full"][k]), k
        assert torch.equal(v, z[1]["full"][k]), k
    for i, st in dp[0]["moments"].items():
        for k, v in st.items():
            assert torch.equal(v, z[0]["moments"][i][k]), (i, k)
    assert z[0]["bytes"][0] == dp[0]["bytes"][0]
    assert z[0]["bytes"][1] < dp[0]["bytes"][1]


@pytest.mark.parametrize("name", ["zero1", "zero1_adamw", "tp2_group_zero1_w4",
                                  "bsgs_tp2_zero1_w4", "resume_w4"])
def test_zero1_steps_views_of_the_parameters(worlds, name):
    """Each slice ZeRO-1's optimizer steps shares its parameter's storage:
    a rank holds the parameter once, plus the moments of its slice."""
    world = CASES[name][0]
    for rank in ranks_of(worlds[world][0], name, world):
        assert rank["zero_views"] and all(rank["zero_views"])


@pytest.mark.parametrize("name", ["fsdp", "bsgs_fsdp", "tp2_group_zero1_w4"])
def test_attribute_reads_outside_a_forward_are_local(worlds, name):
    """Rank 0 alone reads every parameter, FSDP's shards included, as its
    module's attribute outside a forward: it gets the parameter it holds,
    and no collective starts (the world would wait for rank 1)."""
    world = CASES[name][0]
    reads = ranks_of(worlds[world][0], name, world)[0]["attr_reads"]
    assert reads and all(reads.values()), [n for n, ok in reads.items() if not ok]


@pytest.mark.parametrize("name", ["fsdp", "zero1_adamw", "tp2_save",
                                  "tp2_group_zero1_w4"])
def test_a_rank_that_does_not_write_keeps_no_gathered_tensor(worlds, name):
    """What a checkpoint save keeps on a rank other than 0: every entry the
    rules shard is gathered and dropped, and so is every moment; only the
    entries each rank holds whole stay."""
    world = CASES[name][0]
    for rank in ranks_of(worlds[world][0], name, world):
        whole = sorted(k for k, v in rank["full"].items()
                       if rank["local"][k].shape == v.shape)
        if name != "zero1_adamw":
            assert len(whole) < len(rank["full"])
        assert rank["kept"] == whole
        assert rank["kept_moments"] == 0


def test_tp_zero1_resume_is_bit_equal(worlds):
    """tp = 2 + ZeRO-1 over 4 ranks, 4 AdamW steps, saved and resumed after
    the second (a new model, runner and optimizer load the whole-layout
    checkpoint): bit-equal to the uninterrupted run."""
    tmp = worlds[4][0]
    resumed, straight = ranks_of(tmp, "resume_w4", 4), ranks_of(tmp, "straight_w4", 4)
    assert_ranks_agree(resumed)
    assert resumed[0]["losses"] == straight[0]["losses"]
    for k, v in straight[0]["full"].items():
        assert torch.equal(v, resumed[0]["full"][k]), k


def test_tp_checkpoint_loads_into_a_data_parallel_run(worlds):
    """The tp = 2 run's checkpoint holds the whole layout: a one-process
    runner loads it strictly, parameters equal to the ranks' gathered ones,
    AdamW's moments whole, and steps on."""
    tmp, flax_model, _, batches = worlds[2]
    ranks = ranks_of(tmp, "tp2_save", 2)
    cfg = config.update_cfg(clip_config.task_cfg_init_fn, None,
                            TINY + ADAMW + ["data.batch_size=8"],
                            preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    model = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
    meta = load_checkpoint(str(tmp / "tp2_save_ckpt"), runner.model,
                           runner.optimizer)
    assert meta["step"] == 2
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, ranks[0]["full"][k]), k
    qkv = runner.model.image_tower.blocks[0].attn.qkv.weight
    exp_avg = runner.optimizer.base.state[qkv]["exp_avg"]
    assert exp_avg.shape == qkv.shape and exp_avg.abs().sum() > 0
    batch = {k: torch.from_numpy(batches[f"tp2_save_0_{k}"])
             for k in ("image", "input_ids", "attention_mask")}
    assert np.isfinite(float(runner.batch_processor(batch)["loss"]))


# ------------------------------------------------------------- entry point

ENTRY = r'''
import os, random, sys, unittest.mock
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
import datetime
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
import simseg_tpu_torch.core.runner as port_runner
import simseg_tpu_torch.core.train_hooks as port_hooks
from simseg_tpu_torch.parallel.sharding import full_state_dict
from simseg_tpu_torch.tasks.clip import train
batches, losses, summaries = [], [], []
inner = port_runner.CLIPRunner.batch_processor
after_val = port_hooks.RetrievalEvalHook.after_val_epoch
def keep(runner, batch, device_batch=None):
    out = inner(runner, batch, device_batch)
    batches.append({k: np.asarray(v) for k, v in runner._host_batch(batch).items()})
    losses.append(float(out["loss"]))
    return out
def keep_summary(hook, runner):
    after_val(hook, runner)
    summaries.append(dict(runner.state.retrieval_summary))
random.seed(0)
np.random.seed(0)
with unittest.mock.patch.object(port_runner.CLIPRunner, "batch_processor", keep), \
        unittest.mock.patch.object(port_hooks.RetrievalEvalHook,
                                   "after_val_epoch", keep_summary):
    runner = train.main(sys.argv[1:])
torch.save({"batches": batches, "losses": losses, "summaries": summaries,
            "full": full_state_dict(runner.model), "step": runner.step},
           os.path.join(os.environ["OUT"], f"entry_{dist.get_rank()}.pt"))
'''


def test_train_main_over_two_tp_ranks_matches_jax(tmp_path):
    """``main(argv)`` with ``dist.tp_size=2`` over 2 gloo ranks (one model
    group, one data rank) against JAX's ``CLIPRunner`` on a tp = 2 mesh:
    3 Adam steps with validation after each. Both ranks train on the same
    batches (the group's first rank broadcasts them), bit-equal to JAX's;
    losses within 1e-4 relative, R@1/5/10 and RSUM within 1e-6."""
    write_pair_set(tmp_path / "data", "pairs", 28, 16, seed=12)
    yaml = tmp_path / "clip.yaml"
    yaml.write_text(CLIP_YAML)
    vocab = make_test_vocab(WORDS)
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    overrides = OVERRIDES + ["dist.tp_size=2"]
    cfg = jax_update_cfg(jax_task_cfg_init_fn, str(yaml),
                         overrides + [f"data.data_path={tmp_path}/data/",
                                      f"ckpt.dir={tmp_path}/jax"],
                         preprocess_fn=jax_update_clip_config,
                         target=jax_new_base_cfg())
    mesh = jax_make_mesh(tp_size=2)
    model = jax_build_clip_model(cfg, mesh=mesh)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32)}))
    want_batches = []
    inner = JaxRunner.batch_processor

    def keep(runner, batch, device_batch=None):
        want_batches.append(batch)
        return inner(runner, batch, device_batch)

    random.seed(0)
    np.random.seed(0)
    loaders = jax_build_loaders(cfg, tokenizer=JaxTokenizer(dict(vocab)))
    with unittest.mock.patch.object(JaxRunner, "batch_processor", keep):
        runner = JaxRunner(cfg, model, loaders, params=params, mesh=mesh)
        want = _JaxRecord()
        runner.register_hook(want, JaxPriority.LOWEST)
        runner.run()
    torch.save({"state_dict": flax_params_to_state_dict(
        {"params": params["params"]})}, tmp_path / "init.pth")

    argv = ["--cfg", str(yaml), "--vocab_file", str(tmp_path / "vocab.txt"),
            "--device", "cpu", f"data.data_path={tmp_path}/data/",
            f"ckpt.dir={tmp_path}/port",
            f"ckpt.external_resume={tmp_path}/init.pth"] + overrides
    run_world(2, ENTRY.replace("sys.argv[1:]", repr(argv)),
              {"OUT": str(tmp_path)})
    ranks = [torch.load(tmp_path / f"entry_{r}.pt", weights_only=False)
             for r in range(2)]
    for got in ranks:
        assert got["step"] == STEPS and len(got["batches"]) == STEPS
        for b, ref in zip(got["batches"], want_batches):
            np.testing.assert_array_equal(b["image"], ref["image"])
            for k in ("input_ids", "attention_mask"):
                np.testing.assert_array_equal(b[k], ref[k])
        np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-4)
        assert len(got["summaries"]) == len(want.summaries) == STEPS
        for s, ref in zip(got["summaries"], want.summaries):
            for k in ref:
                assert abs(s[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k])), k
    for k, v in ranks[0]["full"].items():
        assert torch.equal(v, ranks[1]["full"][k]), k


def test_launcher_trains_bsgs_over_a_tp_group(tmp_path):
    """``python -m simseg_tpu_torch.launch`` with 2 ranks, ``dist.tp_size=2``
    and runner ``clip_bsgs`` (micro-batches of 4), SGD: its checkpoint,
    written whole, against one process's ``main(argv)`` on the same set
    within JAX's tp bar (rtol 3e-4, atol 1e-6)."""
    from simseg_tpu_torch.tasks.clip import train
    from tests.test_torch_port_distributed_eval import (_finish, _launch,
                                                        _model_state,
                                                        _train_fixture)

    _train_fixture(tmp_path)
    bsgs = ["runner.name=clip_bsgs", "data.batch_size_train=4", "epoch=1",
            *SGD]
    rc, out = _finish(_launch(tmp_path, "tp", "dist.tp_size=2", *bsgs))
    assert rc == 0, out[-3000:]
    got = _model_state(tmp_path / "tp" / "toytrain")
    one = train.main(["--cfg", str(tmp_path / "clip.yaml"), "--vocab_file",
                      str(tmp_path / "vocab.txt"), "--device", "cpu",
                      f"data.data_path={tmp_path}/data/",
                      "data.train_name=[pairs]", "data.enable_valid=False",
                      f"ckpt.dir={tmp_path}/one", *bsgs])
    assert got["step"] == one.step == 2
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                   rtol=3e-4, atol=1e-6, err_msg=k)
