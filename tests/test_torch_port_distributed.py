"""PyTorch port (simseg_tpu_torch): data parallelism over a gloo world of
CPU processes (``parallel/``, the train step, BSGS and the runner over W
ranks) against the JAX package on a W-device mesh of the test process's
8 virtual devices (``tests/test_train_step.py``'s way), with the tiny
towers (``tests/test_models.py:tiny_clip``, 32 px) carried across by the
port's converter and the batches made with numpy from a seed.

The ranks run the worker below (torch only, one thread a rank) through
``CLIPRunner.batch_processor`` on their contiguous shard of each global
batch; each world runs its cases in one set of processes, under a time
limit of its own, and every ``init_process_group`` has a timeout, so a
deadlock fails the test instead of hanging the run.

Bars: loss within rtol 1e-5 of JAX's at every step; parameters after the
SGD steps within JAX's own mesh bar (``tests/test_train_step.py``: rtol
2e-4, atol 1e-6); after one AdamW step at the vit-b YAML's lr (1e-4) atol 1e-5, the key
projections' biases within 2 lr (their gradient is zero in exact arithmetic and Adam
scales either side's noise to lr, as ``tests/test_torch_port_train.py``
notes); the ranks' parameters bit-equal to each other.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.bsgs import make_bsgs_train_step as jax_make_bsgs_train_step
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.parallel.mesh import loss_group_samples as jax_group_samples
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.parallel.mesh import shard_batch
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from tests.test_torch_port_train import _FIELDS, SEQ, TINY, _key_bias, _pair, _trees

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_LIMIT = 180          # seconds a world's processes may take
LR = 1e-3
SGD = ["optim.name=torch.optim.SGD", "optim.param={'momentum': 0.0}",
       "optim.lr.name=constant_schedule", f"optim.lr.init={LR}"]
ADAM_LR = 1e-4             # the vit-b YAML's lr.init
ADAMW = ["optim.name=torch.optim.AdamW",
         "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.001}",
         "optim.lr.name=constant_schedule", f"optim.lr.init={ADAM_LR}"]

# name -> (world, global batch, steps, config overrides, JAX options)
CASES = {
    "nce": (2, 8, 3, SGD, {}),
    "mixup_shard": (2, 8, 3, SGD + ["loss.name=MixUpNCE", "mixup.pairing=shard"],
                    {"loss_name": "MixUpNCE", "pairing": "shard"}),
    "mixup_global": (2, 8, 3, SGD + ["loss.name=MixUpNCE",
                                     "mixup.pairing=global"],
                     {"loss_name": "MixUpNCE", "pairing": "global"}),
    "adamw": (2, 8, 1, ADAMW, {}),
    "bsgs": (2, 16, 2, SGD + ["runner.name=clip_bsgs", "data.batch_size_train=4"],
             {"bsgs": 4}),
    "bsgs_mixup": (2, 16, 2, SGD + ["runner.name=clip_bsgs",
                                    "data.batch_size_train=4", "loss.name=MixUpNCE"],
                   {"bsgs": 4, "loss_name": "MixUpNCE"}),
    "nce_w4": (4, 8, 3, SGD, {}),
    "group_w4": (4, 8, 3, SGD + ["loss.group_size=2"], {"group": 2}),
    "mixup_group_w4": (4, 8, 3, SGD + ["loss.group_size=2", "loss.name=MixUpNCE"],
                       {"group": 2, "loss_name": "MixUpNCE", "pairing": "shard"}),
    "bsgs_group_w4": (4, 16, 2, SGD + ["loss.group_size=2", "runner.name=clip_bsgs",
                                       "data.batch_size_train=4"],
                      {"group": 2, "bsgs": 4}),
}
# accumulation over 2 steps with the towers rematerialised, W = 2 against
# one process at the global batch (port against port)
ACCUM = (2, 8, 4, SGD + ["optim.grad_accum_steps=2"])

WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch import config
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.engine.train_step import rank_key, step_key
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import (all_gather, broadcast_object,
    init_distributed, make_mesh, process_allgather, rank, world_size)
from simseg_tpu_torch.tasks.clip import config as clip_config

init_distributed(device="cpu", timeout=60)
r, w = rank(), world_size()
spec = json.load(open(os.environ["SPEC"]))
out = os.environ["OUT"]
data = np.load(spec["batches"])
state = torch.load(spec["state"])
facts = {}

# collectives: all_gather forward and backward, over the world and a group
x = (torch.arange(6.0).reshape(3, 2) + 10 * r).requires_grad_(True)
y = all_gather(x)
weights = torch.arange(float(y.numel())).reshape(y.shape)
(y * weights).sum().backward()
facts["gather"] = y.tolist()
facts["gather_grad"] = x.grad.tolist()
facts["weights"] = weights.tolist()
if w == 4:
    x.grad = None
    mesh = make_mesh(2)
    yg = all_gather(x, mesh.group)
    (yg * weights[:6]).sum().backward()
    facts["group_gather"] = yg.tolist()
    facts["group_grad"] = x.grad.tolist()
big = np.array([2**40 + 1 + r, -(2**40) - r], np.int64)
g64 = process_allgather(big)
facts["int64"] = [str(v) for v in g64.reshape(-1)] + [str(g64.dtype)]
f64 = process_allgather(np.array([1.0 / 3.0 + r, 2.0**53 - 1], np.float64))
facts["float64"] = f64.tobytes().hex()
facts["object"] = broadcast_object({"run": "abc", "step": 7, "r": r}
                                   if r == 0 else None)

# dropout: one key on every rank, the ranks' masks differ and replay
drop = CLIPModel(**spec["fields"], dropout=0.3)
drop.load_state_dict(state, strict=False)
ones = {k: torch.from_numpy(data[f"nce_0_{k}"][:2]) for k in
        ("image", "input_ids", "attention_mask")}
key = rank_key(step_key(0, 5), make_mesh())
with torch.no_grad():
    a = drop(ones, deterministic=False, key=key)[0]
    b = drop(ones, deterministic=False, key=key)[0]
    peers = all_gather(a)
facts["dropout_replays"] = bool(torch.equal(a, b))
facts["dropout_ranks_differ"] = all(
    not torch.equal(peers[:2], peers[2 * i:2 * i + 2]) for i in range(1, w))
json.dump(facts, open(f"{out}/facts_{r}.json", "w"))

for name, case in spec["cases"].items():
    cfg = config.update_cfg(clip_config.task_cfg_init_fn, None, case["argv"],
                            preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    model = CLIPModel(**spec["fields"], **case.get("model", {}))
    model.load_state_dict(state)
    runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
    losses = []
    for step in range(case["steps"]):
        glob = {k: data[f"{case['data']}_{step}_{k}"]
                for k in ("image", "input_ids", "attention_mask")}
        n = glob["image"].shape[0] // w
        local = {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in glob.items()}
        losses.append(float(runner.batch_processor(local)["loss"]))
        runner.step += 1
    torch.save({"losses": losses, "state": runner.model.state_dict()},
               f"{out}/{name}_{r}.pt")
print("WORKER_DONE", r, flush=True)
'''


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world, code, env_extra, limit=WORLD_LIMIT):
    """``code`` in ``world`` CPU processes joined by gloo; fails on any
    rank's non-zero exit or on the time limit."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, REPO=REPO, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1", **env_extra)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=limit)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, SEQ), np.int64)
    mask[1, 5:] = 0
    mask[n - 1, 3:] = 0
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "input_ids": rng.integers(0, 128, (n, SEQ)),
            "attention_mask": mask}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model's JAX parameters, the port's state dict of them, the
    global batches of every case, and each world's ranks run once."""
    tmp = tmp_path_factory.mktemp("dist")
    flax_model, params, port = _pair()
    torch.save(port.state_dict(), tmp / "state.pt")
    fields = {f: getattr(flax_model, f) for f in _FIELDS}
    batches = {}
    for name, (_, n, steps, _, _) in {**CASES, "accum": (*ACCUM, None)}.items():
        for s in range(steps):
            for k, v in _batch(n, 100 * len(name) + s).items():
                batches[f"{name}_{s}_{k}"] = v
    np.savez(tmp / "batches.npz", **batches)
    runs = {}
    for world in (2, 4):
        cases = {name: {"argv": TINY + argv + [f"data.batch_size={n}"],
                        "steps": steps, "data": name}
                 for name, (w, n, steps, argv, _) in CASES.items() if w == world}
        if world == 2:
            w_, n, steps, argv = ACCUM
            cases["accum"] = {"argv": TINY + argv + [f"data.batch_size={n}"],
                              "steps": steps, "data": "accum",
                              "model": {"remat": True}}
        out = tmp / f"w{world}"
        out.mkdir()
        spec = out / "spec.json"
        spec.write_text(json.dumps({"state": str(tmp / "state.pt"),
                                    "batches": str(tmp / "batches.npz"),
                                    "fields": fields, "cases": cases}))
        run_world(world, WORKER, {"SPEC": str(spec), "OUT": str(out)})
        runs[world] = out
    return flax_model, params, fields, tmp / "batches.npz", runs


def _ranks(setup, name, world):
    out = setup[4][world]
    return [torch.load(out / f"{name}_{r}.pt") for r in range(world)]


def _facts(setup, world):
    return [json.loads((setup[4][world] / f"facts_{r}.json").read_text())
            for r in range(world)]


def _jax_run(flax_model, params, batches, name, world, n, steps, argv, opts):
    """JAX's losses and final parameters on a ``world``-device mesh."""
    _, ref_cfg = _trees(TINY + argv + [f"data.batch_size={n}"])
    mesh = jax_make_mesh(jax.devices()[:world], group_size=opts.get("group", -1))
    groups = jax_group_samples(mesh, n)
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    mixup = opts.get("loss_name") == "MixUpNCE"
    if "bsgs" in opts:
        step = jax_make_bsgs_train_step(flax_model, tx, set_lr,
                                        num_micro=n // opts["bsgs"], mesh=mesh,
                                        group_size=groups, mixup=mixup,
                                        donate=False)
    else:
        step = jax_make_train_step(
            flax_model, tx, set_lr, mesh=mesh, group_size=groups, donate=False,
            loss_name=opts.get("loss_name", "NCE"),
            mixup_shards=world if opts.get("pairing", "shard") == "shard" else 1)
    losses = []
    for s in range(steps):
        batch = {k: batches[f"{name}_{s}_{k}"]
                 for k in ("image", "input_ids", "attention_mask")}
        state, m = step(state, shard_batch(batch, mesh), None,
                        ADAM_LR if argv is ADAMW else LR)
        losses.append(float(m["loss"]))
    return losses, flax_params_to_state_dict(jax.tree.map(np.asarray, state.params))


def _assert_ranks_equal(ranks):
    for other in ranks[1:]:
        assert other["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(v, other["state"][k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_world_step_matches_jax_mesh(setup, name):
    flax_model, params, _, batches_path, _ = setup
    world, n, steps, argv, opts = CASES[name]
    ranks = _ranks(setup, name, world)
    _assert_ranks_equal(ranks)
    losses, want = _jax_run(flax_model, params, np.load(batches_path), name,
                            world, n, steps, argv, opts)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for key, value in ranks[0]["state"].items():
        a, b = value.numpy(), want[key].numpy()
        if "adamw" in name:
            keys = _key_bias(key, a.size)
            if keys is not None:
                assert np.all(np.abs(a[keys] - b[keys]) <= 2 * ADAM_LR), key
                a, b = np.delete(a, keys), np.delete(b, keys)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6, err_msg=key)


def test_accumulation_and_remat_over_two_ranks_equal_one_process(setup):
    """``optim.grad_accum_steps=2`` with the towers under remat at W = 2
    against one process at the global batch (the reduced gradient goes
    into the running mean)."""
    _, _, fields, batches_path, _ = setup
    ranks = _ranks(setup, "accum", 2)
    _assert_ranks_equal(ranks)
    world, n, steps, argv = ACCUM
    cfg, _ = _trees(TINY + argv + [f"data.batch_size={n}"])
    model = CLIPModel(**fields, remat=True)
    model.load_state_dict(torch.load(batches_path.parent / "state.pt"))
    runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
    batches = np.load(batches_path)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(batches[f"accum_{s}_{k}"])
                 for k in ("image", "input_ids", "attention_mask")}
        losses.append(float(runner.batch_processor(batch)["loss"]))
        runner.step += 1
    assert runner.optimizer.mini_step == 0
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for key, value in runner.model.state_dict().items():
        np.testing.assert_allclose(ranks[0]["state"][key].numpy(), value.numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_forward_and_backward(setup, world):
    """Forward: the ranks' rows in rank order; backward: every rank's loss
    ``sum(gathered * weights)`` differentiated, the gathered gradient summed
    over the ranks and this rank's rows kept (W x its rows of the
    weights); at W = 4 also within gather groups of 2 ranks."""
    facts = _facts(setup, world)
    want = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                           for r in range(world)])
    weights = np.asarray(facts[0]["weights"])
    for r, f in enumerate(facts):
        np.testing.assert_array_equal(f["gather"], want)
        np.testing.assert_array_equal(f["gather_grad"],
                                      world * weights[3 * r:3 * r + 3])
        if world == 4:
            lo = 2 * (r // 2)
            np.testing.assert_array_equal(f["group_gather"], want[3 * lo:3 * lo + 6])
            np.testing.assert_array_equal(
                f["group_grad"], 2 * weights[:6][3 * (r % 2):3 * (r % 2) + 3])


@pytest.mark.parametrize("world", [2, 4])
def test_process_allgather_keeps_64_bit_words(setup, world):
    for f in _facts(setup, world):
        got = f["int64"]
        assert got[-1] == "int64"
        assert got[:-1] == [str(v) for r in range(world)
                            for v in (2**40 + 1 + r, -(2**40) - r)]
        want = np.array([[1.0 / 3.0 + r, 2.0**53 - 1] for r in range(world)],
                        np.float64)
        assert f["float64"] == want.tobytes().hex()


@pytest.mark.parametrize("world", [2, 4])
def test_broadcast_object_carries_rank_zeros_dict(setup, world):
    for f in _facts(setup, world):
        assert f["object"] == {"run": "abc", "step": 7, "r": 0}


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_draw_different_dropout_masks_that_replay(setup, world):
    """One step key on every rank: ``rank_key`` folds the rank in, so the
    ranks' masks differ on identical inputs, and each replays by key."""
    for f in _facts(setup, world):
        assert f["dropout_replays"]
        assert f["dropout_ranks_differ"]


ENTRY = r'''
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
import datetime
# a world joined before the entry point runs, as a wrapper under torchrun
# would: the loaders then shard by rank
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
from simseg_tpu_torch.tasks.clip import train
runner = train.main(sys.argv[1:])
torch.save(runner.model.state_dict(),
           os.path.join(os.environ["OUT"], f"entry_{dist.get_rank()}.pt"))
'''


def test_entry_point_over_two_ranks_trains_one_model(tmp_path):
    """The fault of a world whose ranks each trained a model of their own on
    their shard: ``tasks.clip.train.main`` over 2 gloo ranks, 3 SGD steps of
    the global batch 8. Both ranks' parameters are equal to each other and
    to one process's main() on the same set."""
    from simseg_tpu_torch.data.tokenizer import make_test_vocab
    from simseg_tpu_torch.tasks.clip import train
    from tests.test_torch_port_pair_data import WORDS, write_pair_set
    from tests.test_train_cli import CLIP_YAML

    write_pair_set(tmp_path / "data", "pairs", 24, 4, seed=3)
    (tmp_path / "clip.yaml").write_text(CLIP_YAML)
    (tmp_path / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    argv = ["--cfg", str(tmp_path / "clip.yaml"), "--vocab_file",
            str(tmp_path / "vocab.txt"), "--device", "cpu",
            f"data.data_path={tmp_path}/data/", "data.train_name=[pairs]",
            "data.enable_valid=False", "data.train_steps=3",
            "ckpt.step_interval=-1", *SGD]
    code = ENTRY.replace("sys.argv[1:]", repr(argv + [f"ckpt.dir={tmp_path}/w2"]))
    run_world(2, code, {"OUT": str(tmp_path)})
    ranks = [torch.load(tmp_path / f"entry_{r}.pt") for r in range(2)]
    one = train.main(argv + [f"ckpt.dir={tmp_path}/w1"])
    assert one.step == 3
    for key, value in one.model.state_dict().items():
        assert torch.equal(ranks[0][key], ranks[1][key]), key
        np.testing.assert_allclose(ranks[0][key].numpy(), value.numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
