"""PyTorch port (simseg_tpu_torch): LARS on the sharded legs and the orbax
checkpoint backend on a sharded world.

- LARS (``core/optim.py``) over two gloo ranks on the tp = 2, ZeRO-1 and
  FSDP legs of the tiny CLIP step: each leg's parameters after 2 steps
  equal one process's LARS steps within the sharded legs' bar (rtol 3e-4,
  atol 1e-6, ``tests/test_torch_port_tp.py``), from weights moved off
  their initial constants (no zero bias takes a trust ratio of 1), at lr
  10, so that each step moves a tensor by about 1% of its norm and a trust
  ratio taken from a shard's norm in place of the whole tensor's fails the
  bar (weight decay 1e-2: the attention key biases' gradients are zero up
  to rounding, softmax being blind to a shift of every key, so their
  update direction is the decay's, not the rounding's, which LARS would
  scale up by its trust ratio); one process's LARS step against JAX's
  ``optax.lars`` step (``make_train_step``) on the same weights and
  batches, losses 1e-4 and parameters at the same bar.
- The orbax backend (``checkpoint/native.py``, on
  ``torch.distributed.checkpoint``) on a 2-rank FSDP world under AdamW:
  saved after step 2, restored into a fresh runner and run to step 4, bit
  for bit the uninterrupted run; no collective that moves tensors runs
  while it saves or restores; each element of the whole state is written
  once over the ranks (the bytes of every rank's files against the whole
  state's); each rank's part indices (``ShardPlan.index``) select its
  parts from the whole tensors; one process reads the directory's
  parameters whole, equal to the world's gathered parameters.
"""

import jax
import numpy as np
import pytest
import torch

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.parallel.mesh import loss_group_samples as jax_group_samples
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.parallel.mesh import shard_batch
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.checkpoint.native import complete_steps, load_params
from simseg_tpu_torch.core.optim import LARS
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.tasks.clip import config as clip_config
from tests.test_torch_port_tp import (MIN_SIZE, TINY, make_batches, ranks_of,
                                      run_world)
from tests.test_torch_port_train import _FIELDS, _trees
from tests.test_torch_port_train import _pair as _tiny_pair

torch.set_num_threads(2)

LR = 10.0
LARS_ARGV = ["optim.name=LARS",
             "optim.param={'momentum': 0.9, 'weight_decay': 1e-2, "
             "'trust_coefficient': 0.001}",
             "optim.lr.name=constant_schedule", f"optim.lr.init={LR}"]
ADAMW = ["optim.name=torch.optim.AdamW",
         "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.001}",
         "optim.lr.name=constant_schedule", "optim.lr.init=1e-3"]
N, STEPS = 8, 2

# name -> (config overrides, steps, the orbax save's step or None)
CASES = {
    "lars_tp2": (LARS_ARGV + ["dist.tp_size=2"], STEPS, None),
    "lars_zero1": (LARS_ARGV + ["dist.zero1=True"], STEPS, None),
    "lars_fsdp": (LARS_ARGV + ["dist.fsdp=True"], STEPS, None),
    "orbax_fsdp": (ADAMW + ["dist.fsdp=True"], 4, 2),
}

def _pair():
    """The tiny model pair with every parameter moved off its initial
    constant by a little noise (JAX's and the port's the same weights)."""
    flax_model, params, _ = _tiny_pair()
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a + rng.normal(size=a.shape) * 0.05, np.float32),
        params)
    port = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port


WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.native import (load_checkpoint_orbax,
                                                make_orbax_manager,
                                                save_checkpoint_orbax)
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import init_distributed, make_mesh, rank
from simseg_tpu_torch.parallel.sharding import full_state_dict, shard_model
from simseg_tpu_torch.tasks.clip import config as clip_config

init_distributed(device="cpu", timeout=60)
r = rank()
spec = json.load(open(os.environ["SPEC"]))
out = os.environ["OUT"]
data = np.load(spec["batches"])
state = torch.load(spec["state"])
KEYS = ("image", "input_ids", "attention_mask")
MOVING = ("all_gather", "all_gather_into_tensor", "all_gather_object",
          "gather", "broadcast", "broadcast_object_list", "all_reduce",
          "reduce_scatter_tensor", "all_to_all_single", "send", "recv",
          "scatter")


class Count:
    """Counts the collectives that move tensors while it is entered."""

    def __enter__(self):
        self.n, self.orig = 0, {}
        for name in MOVING:
            fn = getattr(dist, name)
            self.orig[name] = fn

            def wrapped(*a, _fn=fn, **k):
                self.n += 1
                return _fn(*a, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(dist, name, fn)


def runner_of(case):
    cfg = config.update_cfg(clip_config.task_cfg_init_fn, None, case["argv"],
                            preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    model = CLIPModel(**spec["fields"])
    model.load_state_dict(state)
    d = cfg.dist
    mesh = make_mesh(int(cfg.loss.group_size), int(d.tp_size))
    shard_model(model, mesh, tp=int(d.tp_size), fsdp=bool(d.fsdp),
                zero1=bool(d.zero1), fsdp_min_size=spec["min_size"],
                zero1_min_size=spec["min_size"])
    return CLIPRunner(cfg, model, {"train": []}, device="cpu"), mesh


def run_steps(runner, mesh, case, first, last, rec):
    for step in range(first, last):
        glob = {k: data[f"{case['data']}_{step}_{k}"] for k in KEYS}
        n = glob["image"].shape[0] // mesh.data_size
        d = mesh.data_rank
        local = {k: torch.from_numpy(v[d * n:(d + 1) * n]) for k, v in glob.items()}
        rec["losses"].append(float(runner.batch_processor(local)["loss"]))
        runner.step += 1


for name, case in spec["cases"].items():
    runner, mesh = runner_of(case)
    rec = {"losses": []}
    save_at = case["save_at"]
    if save_at is None:
        run_steps(runner, mesh, case, 0, case["steps"], rec)
    else:
        mgr = make_orbax_manager(os.path.join(out, name))
        run_steps(runner, mesh, case, 0, save_at, rec)
        with Count() as c:
            save_checkpoint_orbax(mgr, save_at, runner.model, runner.optimizer,
                                  {"step": save_at, "epoch": 0})
            mgr.wait_until_finished()
        rec["save_moves"] = c.n
        plan = runner.model.shard_plan
        # the whole state's bytes (gathered after the save) and each part's
        # indices against the whole tensors
        whole = full_state_dict(runner.model)
        # a copy: the entries no rule shards are the live parameters
        rec["saved_full"] = {k: v.clone() for k, v in whole.items()}
        moments = runner.optimizer.state_dict()["base"]["state"]
        rec["whole_bytes"] = sum(v.numel() * v.element_size()
                                 for v in whole.values()) + sum(
            v.numel() * v.element_size() for st in moments.values()
            for v in st.values() if torch.is_tensor(v))
        local = runner.model.state_dict()
        rec["index_ok"] = all(
            torch.equal(whole[k][np.ix_(*plan.index(s))], local[k])
            for k, s in plan.specs.items() if k in local)
        run_steps(runner, mesh, case, save_at, case["steps"], rec)
        resumed, _ = runner_of(case)
        rec["resumed_losses"] = []
        with Count() as c:
            meta = load_checkpoint_orbax(mgr, resumed.model, resumed.optimizer)
        rec["load_moves"] = c.n
        rec["meta"] = meta
        resumed.step = meta["step"]
        res = {"losses": []}
        run_steps(resumed, mesh, case, save_at, case["steps"], res)
        rec["resumed_losses"] = res["losses"]
        rec["resumed_full"] = full_state_dict(resumed.model)
        rec["resumed_moments"] = resumed.optimizer.state_dict()["base"]["state"]
        rec["moments"] = runner.optimizer.state_dict()["base"]["state"]
    rec["full"] = full_state_dict(runner.model)
    torch.save(rec, f"{out}/{name}_{r}.pt")
print("WORKER_DONE", r, flush=True)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases in one world of 2 gloo ranks; the tiny model's JAX
    parameters and the batches."""
    import json

    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    flax_model, params, port = _pair()
    torch.save(port.state_dict(), tmp / "state.pt")
    batches, cases = {}, {}
    for i, (name, (argv, steps, save_at)) in enumerate(CASES.items()):
        data = "lars" if name.startswith("lars") else name
        batches.update(make_batches(data, N, steps, 700 + 10 * i))
        cases[name] = {"argv": TINY + argv + [f"data.batch_size={N}"],
                       "steps": steps, "data": data, "save_at": save_at}
    np.savez(tmp / "batches.npz", **batches)
    fields = {f: getattr(flax_model, f) for f in _FIELDS}
    (tmp / "spec.json").write_text(json.dumps({
        "state": str(tmp / "state.pt"), "batches": str(tmp / "batches.npz"),
        "fields": fields, "cases": cases, "min_size": MIN_SIZE}))
    run_world(2, WORKER, {"SPEC": str(tmp / "spec.json"), "OUT": str(tmp)})
    return tmp, flax_model, params, port.state_dict(), batches


def _one_process(state, batches, argv, steps):
    """One process's run of the tiny step on the global batches: (losses,
    parameters)."""
    cfg = config.update_cfg(clip_config.task_cfg_init_fn, None,
                            TINY + argv + [f"data.batch_size={N}"],
                            preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    model = CLIPModel(**{f: v for f, v in _fields(cfg).items()})
    model.load_state_dict(state)
    runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
    losses = []
    for step in range(steps):
        batch = {k: torch.from_numpy(batches[f"lars_{step}_{k}"])
                 for k in ("image", "input_ids", "attention_mask")}
        losses.append(float(runner.batch_processor(batch)["loss"]))
        runner.step += 1
    return losses, runner


_FIELD_CACHE = {}


def _fields(cfg):
    if not _FIELD_CACHE:
        flax_model, _, _ = _pair()
        _FIELD_CACHE.update({f: getattr(flax_model, f) for f in _FIELDS})
    return _FIELD_CACHE


@pytest.mark.parametrize("name", ["lars_tp2", "lars_zero1", "lars_fsdp"])
def test_lars_on_a_sharded_leg_equals_one_process(world, name):
    tmp, _, _, state, batches = world
    ranks = ranks_of(tmp, name, 2)
    losses, runner = _one_process(state, batches, LARS_ARGV, STEPS)
    assert isinstance(runner.optimizer.base, LARS)
    assert runner.optimizer.base.counted is None
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    assert ranks[1]["losses"] == ranks[0]["losses"]
    moved = 0.0
    for key, value in runner.model.state_dict().items():
        for rank in ranks:
            np.testing.assert_allclose(rank["full"][key].numpy(), value.numpy(),
                                       rtol=3e-4, atol=1e-6, err_msg=key)
        moved = max(moved, float((value - state[key]).abs().max()
                                 / (state[key].abs().max() + 1e-12)))
    # the trust ratios move the weights by about 1% a step: a shard's norm
    # in place of the whole tensor's could not pass the bar above
    assert moved > 0.01


def test_one_process_lars_matches_optax():
    """The port's LARS step on the tiny CLIP step against JAX's
    ``optax.lars`` step on the same weights and batches."""
    flax_model, params, port = _pair()
    batches = make_batches("lars", N, STEPS, 700)
    losses, runner = _one_process(port.state_dict(), batches, LARS_ARGV, STEPS)
    _, ref_cfg = _trees(TINY + LARS_ARGV + [f"data.batch_size={N}"])
    mesh = jax_make_mesh(jax.devices()[:1])
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    step = jax_make_train_step(flax_model, tx, set_lr, mesh=mesh, donate=False,
                               group_size=jax_group_samples(mesh, N))
    want = []
    for s in range(STEPS):
        batch = {k: batches[f"lars_{s}_{k}"]
                 for k in ("image", "input_ids", "attention_mask")}
        state, m = step(state, shard_batch(batch, mesh), None, LR)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    ref = flax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    for key, value in runner.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=3e-4,
                                   atol=1e-6, err_msg=key)


def test_orbax_fsdp_resume_is_bit_equal(world):
    """Saved after step 2 of 4, restored into a fresh runner on each rank
    and run on: the losses of steps 3-4, the parameters and the AdamW
    moments bit-equal to the uninterrupted run's."""
    tmp = world[0]
    for rank in ranks_of(tmp, "orbax_fsdp", 2):
        assert rank["meta"] == {"step": 2, "epoch": 0}
        assert rank["resumed_losses"] == rank["losses"][2:]
        for k, v in rank["full"].items():
            assert torch.equal(rank["resumed_full"][k], v), k
        for i, st in rank["moments"].items():
            for k, v in st.items():
                assert torch.equal(rank["resumed_moments"][i][k], v), (i, k)
    assert complete_steps(str(tmp / "orbax_fsdp")) == [2]


def test_orbax_fsdp_save_gathers_nothing(world):
    """No collective that moves tensors runs in the save or the restore;
    every element of the whole state (parameters and moments) is written
    once over the two ranks, rank 1 writing only its shards; each rank's
    part indices select its shards from the whole tensors."""
    import torch.distributed.checkpoint as dcp

    tmp = world[0]
    ranks = ranks_of(tmp, "orbax_fsdp", 2)
    written = []
    for r in range(2):
        md = dcp.FileSystemReader(str(tmp / "orbax_fsdp" / "2" / f"rank_{r}")
                                  ).read_metadata().state_dict_metadata
        written.append(sum(int(np.prod(m.size)) * m.properties.dtype.itemsize
                           for m in md.values() if hasattr(m, "size")))
        assert ranks[r]["save_moves"] == 0 and ranks[r]["load_moves"] == 0
        assert ranks[r]["index_ok"]
    assert sum(written) == ranks[0]["whole_bytes"]
    assert 0 < written[1] < written[0]


def test_one_process_reads_the_sharded_directory_whole(world):
    """``load_params`` in this process (no world) on the FSDP world's
    directory: every parameter whole, bit-equal to the parameters the world
    gathered right after its step-2 save."""
    tmp = world[0]
    model = CLIPModel(**_fields(None))
    load_params(str(tmp / "orbax_fsdp"), model)
    saved = ranks_of(tmp, "orbax_fsdp", 2)[0]["saved_full"]
    assert saved.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(value, saved[key]), key
