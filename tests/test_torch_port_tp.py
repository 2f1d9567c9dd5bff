"""PyTorch port (simseg_tpu_torch): tensor and sequence parallelism
(``parallel/tp.py``, ``parallel/sharding.py``) against the JAX package.

The rules: the port's TP, FSDP and ZeRO-1 specs (``plan_specs``) against
JAX's ``tp_shardings``, ``fsdp_shardings`` and ``derive_state_shardings``
(``shard_opt_state``) leaf by leaf, through the converter's names, on the
tiny towers and on the vit-b tree (ViT-B/16 + BERT-base: the port's model
on the ``meta`` device, JAX's tree of the same leaves as shapes; nothing
of that size is allocated or traced).

The steps: gloo worlds of CPU processes built as
``tests/test_torch_port_distributed.py`` builds them (a timeout on every
``init_process_group``, a time limit a world), each rank running
``CLIPRunner.batch_processor`` on its data rank's rows, against JAX's own
step on ``make_mesh(devices[:W], tp_size=...)`` of the test process's 8
virtual devices (the factory form, as ``tests/test_tp.py`` runs it), the
tiny towers carried across by the converter. Bars are JAX's own: the loss
within 1e-4 relative, the parameters within rtol 3e-4, atol 1e-6
(``tests/test_tp.py``); every rank's gathered parameters equal, and the
replicated leaves bit-equal across ranks.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.bsgs import make_bsgs_train_step as jax_make_bsgs_train_step
from simseg_tpu.engine.train_step import TrainState, derive_state_shardings
from simseg_tpu.engine.train_step import make_eval_step as jax_make_eval_step
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.parallel.mesh import MODEL_AXIS
from simseg_tpu.parallel.mesh import loss_group_samples as jax_group_samples
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.parallel.mesh import shard_batch
from simseg_tpu.parallel.tp import fsdp_shardings, tp_shardings
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.convert import (flax_param_path,
                                                 flax_params_to_state_dict)
from simseg_tpu_torch.models.clip import CLIPModel, build_clip_model
from simseg_tpu_torch.parallel.sharding import plan_specs
from simseg_tpu_torch.tasks.clip import config as clip_config
from tests.test_torch_port_distributed import _batch, run_world
from tests.test_torch_port_train import _FIELDS, TINY, _pair, _trees

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
SGD = ["optim.name=torch.optim.SGD", "optim.param={'momentum': 0.9}",
       "optim.lr.name=constant_schedule", f"optim.lr.init={LR}"]
MIN_SIZE = 512           # JAX's tests' fsdp_min_size / opt_shard_min_size

# ----------------------------------------------------------------- the rules


def _jax_specs(tree, mesh, tp, fsdp, zero1, fsdp_min, zero_min):
    """JAX's PartitionSpec of every parameter (or, under ZeRO-1, of its Adam
    moment) by flax path."""
    import optax

    repl = jax.tree.map(lambda _: NamedSharding(mesh, P()), tree)
    param_sh = tp_shardings(tree, mesh) if tp else repl
    if fsdp:
        param_sh = fsdp_shardings(tree, mesh, base=param_sh, min_size=fsdp_min)
    if zero1:
        opt = jax.eval_shape(optax.adam(1e-3).init, tree)
        state = TrainState(params=tree, opt_state=opt, step=None)
        sh = derive_state_shardings(state, mesh, tp=tp, fsdp=fsdp,
                                    shard_opt_state=True,
                                    opt_shard_min_size=zero_min,
                                    fsdp_min_size=fsdp_min)
        param_sh = sh.opt_state[0].mu
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = t
    walk(param_sh, ())
    return out


def _norm(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(tuple(a) if isinstance(a, (list, tuple)) and len(a) > 1
                 else (a[0] if isinstance(a, (list, tuple)) else a)
                 for a in spec)


def _flax_tree(model):
    """The JAX tree of ``model``'s leaves as shapes, by the converter's
    names and layouts."""
    tree = {}
    for name, p in model.named_parameters():
        path = flax_param_path(name).split("/")
        shape = tuple(p.shape)
        if path[-1] == "kernel" and len(shape) == 2:
            shape = shape[::-1]
        elif path[-1] == "kernel" and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jax.ShapeDtypeStruct(shape, np.float32)
    return tree


def _vitb_model():
    cfg = config.update_cfg(clip_config.task_cfg_init_fn,
                            os.path.join(REPO, "configs/clip/simseg.vit-b.yaml"),
                            [], preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    with torch.device("meta"):
        return build_clip_model(cfg)


LEGS = {"tp2": (2, False, False), "fsdp": (1, True, False),
        "tp2_fsdp": (2, True, False), "zero1": (1, False, True),
        "tp2_zero1": (2, False, True), "tp2_fsdp_zero1": (2, True, True)}


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("tree", ["tiny", "vitb"])
def test_sharding_rules_match_jax_leaf_by_leaf(tree, leg):
    """Every parameter's sharded dims (and, under ZeRO-1, its moments') on a
    mesh of the 8 devices, data 8 or (data 4, model 2): the port's rules
    against JAX's, the qkv's by-head chunks aside (same dims, same
    bytes)."""
    tp, fsdp, zero1 = LEGS[leg]
    if tree == "tiny":
        flax_model, params, _ = _pair()
        model = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
        jtree = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                             params)
        mins = (MIN_SIZE, MIN_SIZE)
    else:
        model = _vitb_model()
        jtree = {"params": _flax_tree(model)["params"]}
        mins = (2**14, 2**16)
    mesh = jax_make_mesh(tp_size=tp)
    data = 8 // tp
    want = _jax_specs(jtree, mesh, tp > 1, fsdp, zero1, *mins)
    specs = plan_specs(model, tp=tp, fsdp_ranks=data if fsdp else 1,
                       zero1_ranks=data if zero1 else 1, fsdp_min_size=mins[0],
                       zero1_min_size=mins[1])
    sharded = 0
    for name, spec in specs.items():
        got = spec.flax_spec()
        jax_spec = _norm(want[flax_param_path(name)].spec, len(got))
        assert got == jax_spec, (name, got, jax_spec)
        sharded += any(a is not None for a in got)
    assert sharded >= (12 if tree == "tiny" else 48)


def test_qkv_is_sharded_by_heads():
    """The fused qkv's output rows: each model rank holds q, k and v of its
    own heads (JAX shards the kernel contiguously)."""
    flax_model, _, _ = _pair()
    model = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    specs = plan_specs(model, tp=2)
    qkv = specs["image_encoder.model.model.blocks.0.attn.qkv.weight"]
    assert (qkv.tp_dim, qkv.tp_chunks) == (0, 3)
    proj = specs["image_encoder.model.model.blocks.0.attn.proj.bias"]
    assert proj.tp_dim is None
    out = specs["text_encoder.model.model.encoder.layer.0.output.dense.weight"]
    inter = specs["text_encoder.model.model.encoder.layer.0.intermediate.dense.weight"]
    assert (out.tp_dim, inter.tp_dim) == (1, 0)


def test_indivisible_block_stays_replicated():
    """Three heads over tp = 2: the attention stays whole (JAX would split
    the 3D out dim if it divided; the port keeps heads together), the MLP
    is still sharded."""
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      image_arch=(("embed_dim", 48), ("num_heads", 3)),
                      projection_dim=16)
    specs = plan_specs(model, tp=2)
    pre = "image_encoder.model.model.blocks.0."
    assert specs[pre + "attn.qkv.weight"].tp_dim is None
    assert specs[pre + "attn.proj.weight"].tp_dim is None
    assert specs[pre + "mlp.fc1.weight"].tp_dim == 0


def test_sp_without_tp_raises_jax_value_error():
    from simseg_tpu_torch.parallel.sharding import shard_model

    with pytest.raises(ValueError, match="tp_size"):
        shard_model(CLIPModel(image_tag="vit_test", img_size=32,
                              text_tag="bert_test", projection_dim=16),
                    None, sp=True)


# ----------------------------------------------------------------- the worlds

WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch import config
from simseg_tpu_torch.checkpoint.native import load_checkpoint, save_checkpoint
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import init_distributed, make_mesh, rank
from simseg_tpu_torch.parallel.sharding import (full_state_dict, shard_model,
                                                state_bytes)
from simseg_tpu_torch.tasks.clip import config as clip_config

init_distributed(device="cpu", timeout=60)
r = rank()
spec = json.load(open(os.environ["SPEC"]))
out = os.environ["OUT"]
data = np.load(spec["batches"])
state = torch.load(spec["state"])
KEYS = ("image", "input_ids", "attention_mask")


def runner_of(case):
    cfg = config.update_cfg(clip_config.task_cfg_init_fn, None, case["argv"],
                            preprocess_fn=clip_config.update_clip_config,
                            target=config.new_base_cfg())
    model = CLIPModel(**spec["fields"])
    model.load_state_dict(state)
    d = cfg.dist
    mesh = make_mesh(int(cfg.loss.group_size), int(d.tp_size))
    # JAX's tests' min sizes (the runner keeps a leg already applied)
    shard_model(model, mesh, tp=int(d.tp_size), sp=bool(d.sp),
                fsdp=bool(d.fsdp), zero1=bool(d.zero1),
                fsdp_min_size=spec["min_size"], zero1_min_size=spec["min_size"])
    return CLIPRunner(cfg, model, {"train": []}, device="cpu"), mesh


for name, case in spec["cases"].items():
    runner, mesh = runner_of(case)
    rec = {"losses": []}
    if case.get("eval"):
        batch = {k: torch.from_numpy(data[f"{case['data']}_eval_{k}"])
                 for k in KEYS}
        img, txt = runner._eval_fn(batch)
        rec["eval"] = [img.numpy(), txt.numpy()]
    for step in range(case["steps"]):
        if step == case.get("resume_at"):
            save_checkpoint(os.path.join(out, name), "ckpt", runner.model,
                            runner.optimizer, {"step": step})
            runner, mesh = runner_of(case)
            load_checkpoint(os.path.join(out, name), runner.model,
                            runner.optimizer)
            runner.step = step
        glob = {k: data[f"{case['data']}_{step}_{k}"] for k in KEYS}
        n = glob["image"].shape[0] // mesh.data_size
        d = mesh.data_rank
        local = {k: torch.from_numpy(v[d * n:(d + 1) * n]) for k, v in glob.items()}
        rec["losses"].append(float(runner.batch_processor(local)["loss"]))
        runner.step += 1
        if step == 0:
            rec["bytes"] = state_bytes(runner.model, runner.optimizer)
    rec["full"] = full_state_dict(runner.model)
    rec["local"] = runner.model.state_dict()
    rec["moments"] = runner.optimizer.state_dict()["base"]["state"]
    # what a rank that does not write a checkpoint keeps of the state
    rec["kept"] = sorted(full_state_dict(runner.model, keep=False))
    rec["kept_moments"] = sum(len(st) for st in runner.optimizer.state_dict(
        keep=False)["base"]["state"].values())
    # ZeRO-1: whether each slice the optimizer steps is a view of its parameter
    rec["zero_views"] = [o.untyped_storage().data_ptr()
                         == p.untyped_storage().data_ptr()
                         for p, o, _ in runner.optimizer._zero]
    # rank 0 alone reads every parameter as its module's attribute, outside
    # any forward: the parameter itself (a gather would wait for rank 1)
    rec["attr_reads"] = {}
    if r == 0:
        for n, p in runner.model.named_parameters():
            mod, _, leaf = n.rpartition(".")
            rec["attr_reads"][n] = getattr(runner.model.get_submodule(mod),
                                           leaf) is p
    if case.get("save"):
        save_checkpoint(os.path.join(out, name + "_ckpt"), "ckpt", runner.model,
                        runner.optimizer, {"step": runner.step})
    torch.save(rec, f"{out}/{name}_{r}.pt")
print("WORKER_DONE", r, flush=True)
'''


def run_cases(tmp, world, cases, batches, min_size=MIN_SIZE):
    """The ``cases`` in one ``world`` of gloo ranks; returns its directory."""
    flax_model, params, port = _pair()
    torch.save(port.state_dict(), tmp / "state.pt")
    np.savez(tmp / "batches.npz", **batches)
    fields = {f: getattr(flax_model, f) for f in _FIELDS}
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"state": str(tmp / "state.pt"),
                                "batches": str(tmp / "batches.npz"),
                                "fields": fields, "cases": cases,
                                "min_size": min_size}))
    run_world(world, WORKER, {"SPEC": str(spec), "OUT": str(tmp)})
    return flax_model, params


def make_batches(name, n, steps, seed, eval_n=0):
    out = {}
    for s in range(steps):
        for k, v in _batch(n, seed + s).items():
            out[f"{name}_{s}_{k}"] = v
    if eval_n:
        for k, v in _batch(eval_n, seed + 99).items():
            out[f"{name}_eval_{k}"] = v
    return out


def ranks_of(tmp, name, world):
    return [torch.load(tmp / f"{name}_{r}.pt", weights_only=False)
            for r in range(world)]


def jax_run(flax_model, params, batches, name, world, n, steps, opts):
    """JAX's losses and final parameters (as the port's state dict) on a
    ``world``-device mesh, in the factory form of the sharded legs."""
    argv = TINY + SGD + [f"data.batch_size={n}"]
    _, ref_cfg = _trees(argv)
    tp = opts.get("tp", 1)
    mesh = jax_make_mesh(jax.devices()[:world], group_size=opts.get("group", -1),
                         tp_size=tp)
    model = flax_model
    if opts.get("sp"):
        model = flax_model.clone(act_sharding=NamedSharding(
            mesh, P(None, MODEL_AXIS, None)))
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    kw = dict(mesh=mesh, donate=False, shard_opt_state=opts.get("zero1", False),
              fsdp=opts.get("fsdp", False), opt_shard_min_size=MIN_SIZE,
              fsdp_min_size=MIN_SIZE, group_size=jax_group_samples(mesh, n))
    if "bsgs" in opts:
        built = jax_make_bsgs_train_step(model, tx, set_lr,
                                         num_micro=n // opts["bsgs"], **kw)
    else:
        built = jax_make_train_step(model, tx, set_lr, **kw)
    if tp > 1 or opts.get("zero1") or opts.get("fsdp"):
        step, state = built(state)
    else:
        step = built
    losses = []
    for s in range(steps):
        batch = {k: batches[f"{name}_{s}_{k}"]
                 for k in ("image", "input_ids", "attention_mask")}
        state, m = step(state, shard_batch(batch, mesh), None, LR)
        losses.append(float(m["loss"]))
    return losses, flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                          state.params))


def assert_ranks_agree(ranks, tp_names=()):
    """Every rank's gathered state equal to rank 0's, bit for bit, and so
    are the leaves every rank holds whole."""
    for other in ranks[1:]:
        assert other["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["full"].items():
            assert torch.equal(v, other["full"][k]), k
        for k, v in ranks[0]["local"].items():
            if v.shape == ranks[0]["full"][k].shape and k not in tp_names:
                assert torch.equal(v, other["local"][k]), k


def assert_matches_jax(rank0, losses, want, rtol=3e-4):
    np.testing.assert_allclose(rank0["losses"], losses, rtol=1e-4)
    for key, value in rank0["full"].items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=rtol, atol=1e-6, err_msg=key)


# name -> (world, global batch, steps, config overrides, JAX options)
TP_CASES = {
    "tp2": (2, 8, 3, ["dist.tp_size=2"], {"tp": 2}),
    "tp2_sp": (2, 8, 3, ["dist.tp_size=2", "dist.sp=True"],
               {"tp": 2, "sp": True}),
    "bsgs_tp2": (2, 16, 2, ["dist.tp_size=2", "runner.name=clip_bsgs",
                            "data.batch_size_train=4"], {"tp": 2, "bsgs": 4}),
    "tp2_fsdp_w4": (4, 8, 3, ["dist.tp_size=2", "dist.fsdp=True"],
                    {"tp": 2, "fsdp": True}),
}


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        batches, cases = {}, {}
        for name, (w, n, steps, argv, _) in TP_CASES.items():
            if w != world:
                continue
            batches.update(make_batches(name, n, steps, 300 + len(name),
                                        eval_n=4 if name == "tp2" else 0))
            cases[name] = {"argv": TINY + SGD + argv + [f"data.batch_size={n}"],
                           "steps": steps, "data": name,
                           "eval": name == "tp2"}
        flax_model, params = run_cases(tmp, world, cases, batches)
        out[world] = (tmp, flax_model, params, batches)
    return out


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_leg_matches_jax_mesh(tp_worlds, name):
    world, n, steps, _, opts = TP_CASES[name]
    tmp, flax_model, params, batches = tp_worlds[world]
    ranks = ranks_of(tmp, name, world)
    assert_ranks_agree(ranks)
    losses, want = jax_run(flax_model, params, batches, name, world, n, steps,
                           opts)
    assert_matches_jax(ranks[0], losses, want)
    # each rank holds its shards: qkv's rows split over the model group
    qkv = "image_encoder.model.model.blocks.0.attn.qkv.weight"
    assert ranks[0]["local"][qkv].shape[0] * 2 == ranks[0]["full"][qkv].shape[0]
    assert not torch.equal(ranks[0]["local"][qkv], ranks[1]["local"][qkv])


def test_tp_eval_step_matches_jax(tp_worlds):
    """``make_eval_step`` on the TP mesh (JAX ``tests/test_tp.py:159``):
    the port's TP-sharded model's embeddings against JAX's eval step on
    the TP-placed parameters, before the steps."""
    tmp, flax_model, params, batches = tp_worlds[2]
    ranks = ranks_of(tmp, "tp2", 2)
    mesh = jax_make_mesh(jax.devices()[:2], tp_size=2)
    placed = jax.device_put(params, tp_shardings(params, mesh))
    batch = {k: batches[f"tp2_eval_{k}"]
             for k in ("image", "input_ids", "attention_mask")}
    img, txt = jax_make_eval_step(flax_model, mesh)(placed,
                                                    shard_batch(batch, mesh))
    for r in ranks:
        np.testing.assert_allclose(r["eval"][0], np.asarray(img), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["eval"][1], np.asarray(txt), rtol=1e-5,
                                   atol=1e-6)


def test_tp_state_bytes_are_the_rules_shards(tp_worlds):
    """A rank's parameter and SGD-momentum bytes are what its specs give:
    each sharded dim divided by its ranks."""
    tmp, flax_model, _, _ = tp_worlds[4]
    ranks = ranks_of(tmp, "tp2_fsdp_w4", 4)
    model = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    specs = plan_specs(model, tp=2, fsdp_ranks=2, fsdp_min_size=MIN_SIZE)
    want = 0
    for spec in specs.values():
        n = int(np.prod(spec.shape))
        n //= (2 if spec.tp_dim is not None else 1)
        n //= (2 if spec.fsdp_dim is not None else 1)
        want += 4 * n
    full = sum(4 * int(np.prod(s.shape)) for s in specs.values())
    for r in ranks:
        assert r["bytes"] == (want, want)
    assert want < full
