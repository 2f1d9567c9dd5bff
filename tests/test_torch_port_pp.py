"""PyTorch port (simseg_tpu_torch): pipeline parallelism
(``parallel/pp.py``, the stages of ``parallel/mesh.py``) against the JAX
package (``simseg_tpu/parallel/pp.py``, ``tests/test_pp.py``).

The layout and the refusals run in this process (JAX's exception types and
messages). The schedule runs in gloo worlds of CPU processes built as
``tests/test_torch_port_distributed.py`` builds them: a world of 2 (pp 2)
and one of 4 (pp 4, and pp 2 x data 2), each rank on its data index's
rows, the tiny towers at depth 4 carried across by the converter, against
JAX's pipelined functions and steps on a mesh of as many of the 8 virtual
devices. Bars: the forwards within 1e-5 (JAX's own against its plain
forward); every gradient within 1e-4 of its largest entry (the towers'
float32 bar, ``tests/test_torch_port_tome.py``); the steps' losses within
1e-4 relative and the parameters within JAX's rtol 3e-4, atol 1e-6
(``tests/test_pp.py:150``); every rank's parameters bit-equal.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.parallel.mesh import shard_batch
from simseg_tpu.parallel.pp import make_pp_forward as jax_make_pp_forward
from simseg_tpu.parallel.pp import pp_image_tokens as jax_pp_image_tokens
from simseg_tpu.parallel.pp import pp_text_feature as jax_pp_text_feature
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import mesh as port_mesh
from simseg_tpu_torch.parallel.mesh import DataMesh, batch_shards
from simseg_tpu_torch.parallel.pp import make_pp_forward, ticks
from tests.test_models import tiny_clip
from tests.test_torch_port_distributed import _batch, run_world
from tests.test_torch_port_tp import LR, SGD
from tests.test_torch_port_train import _FIELDS, TINY, _key_bias, _pair, _trees

torch.set_num_threads(2)

DEPTH4 = dict(image_arch=(("depth", 4),), text_arch=(("depth", 4),))
DEPTH_ARGV = ["model.image_encoder.arch={'depth': 4}",
              "model.text_encoder.arch={'depth': 4}"]
TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = ("image", "input_ids", "attention_mask")

# ---------------------------------------------------------------- layout


def test_pp_mesh_layout():
    """(pipe, data) with the pipe outermost (JAX ``tests/test_pp.py:26``):
    rank r is stage r // (W / pp) and data index r % (W / pp); the batch
    splits over the data ranks only."""
    for r in range(8):
        m = DataMesh(8, r, pp=2)
        assert (m.stage, m.data_rank, m.data_size) == (r // 4, r % 4, 4)
        assert m.rank_of_stage(1 - m.stage) == (r + 4) % 8
        assert m.holds_copy == (r >= 4)
    assert batch_shards(DataMesh(8, 0, pp=2)) == 4
    assert ticks(4, 2, 0) == [0, 1, 2, 3] and ticks(2, 4, 3) == [0, 1]


# (pp_size, tp_size, group_size) on 8 devices
MESH_REFUSALS = [(3, 1, -1), (2, 2, -1), (2, 1, 2), (2, 1, 8)]


@pytest.mark.parametrize("pp,tp,group", MESH_REFUSALS)
def test_pp_mesh_refusals_match_jax(monkeypatch, pp, tp, group):
    """A world of 8: ``pp_size`` not dividing it (ValueError), PP with TP or
    gather groups (NotImplementedError), as JAX's ``make_mesh`` refuses
    them on 8 devices."""
    with pytest.raises(Exception) as jerr:
        jax_make_mesh(pp_size=pp, tp_size=tp, group_size=group)
    monkeypatch.setattr(port_mesh, "is_distributed", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda *a: 8)
    with pytest.raises(Exception) as err:
        port_mesh.make_mesh(group, tp, pp)
    assert (type(err.value), str(err.value)) == (type(jerr.value),
                                                 str(jerr.value))


def _message(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


# name -> tiny_clip overrides
FORWARD_REFUSALS = {
    "dropout": dict(dropout=0.1),
    "complex_projection_dropout": dict(projection_name="complex",
                                       projection_dropout=0.1),
    "tome": dict(image_arch=(("tome_r", 2),)),
    "moe_image": dict(image_arch=(("moe_experts", 4),)),
    "moe_text": dict(text_arch=(("moe_experts", 4),)),
    "cnn": dict(image_tag="resnet_test"),
}


@pytest.mark.parametrize("name", list(FORWARD_REFUSALS))
def test_pp_forward_refusals_match_jax(name):
    """``make_pp_forward`` refuses dropout, ToMe, MoE and a CNN image tower
    with JAX's exception and message (``tests/test_pp.py:211-265``)."""
    over = FORWARD_REFUSALS[name]
    jax_model = tiny_clip(**over)
    port = CLIPModel(**{f: getattr(jax_model, f) for f in _FIELDS},
                     **{k: v for k, v in over.items()
                        if k in ("dropout", "projection_dropout")})
    want = _message(jax_make_pp_forward, jax_model,
                    jax_make_mesh(pp_size=2), 2)
    assert _message(make_pp_forward, port, DataMesh(2, 0, pp=2), 2) == want


def test_pp_indivisible_depth_and_micro_refused():
    """A depth the stages do not divide and a batch the microbatches do not
    divide: JAX's ValueErrors (``tests/test_pp.py:223``)."""
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_arch=(("depth", 3),))
    with pytest.raises(ValueError, match="depth 3 not divisible by pp_size 2"):
        make_pp_forward(port, DataMesh(2, 0, pp=2), 2)
    from simseg_tpu_torch.parallel.pp import pipeline_blocks

    with pytest.raises(ValueError, match="not divisible by pp_micro 3"):
        pipeline_blocks(port.image_tower.blocks[:2], torch.zeros(8, 5, 32),
                        DataMesh(2, 0, pp=2), 3)


# ---------------------------------------------------------------- the worlds

WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch import config
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import init_distributed, make_mesh, rank
from simseg_tpu_torch.parallel.pp import pp_image_tokens, pp_text_feature
from simseg_tpu_torch.parallel.sharding import (full_state_dict,
                                                reduce_model_gradients)
from simseg_tpu_torch.tasks.clip import config as clip_config

init_distributed(device="cpu", timeout=60)
r = rank()
spec = json.load(open(os.environ["SPEC"]))
out = os.environ["OUT"]
data = np.load(spec["batches"])
state = torch.load(spec["state"])
KEYS = ("image", "input_ids", "attention_mask")


def local_rows(prefix, mesh):
    glob = {k: data[f"{prefix}_{k}"] for k in KEYS}
    n = glob["image"].shape[0] // mesh.data_size
    d = mesh.data_rank
    return {k: torch.from_numpy(v[d * n:(d + 1) * n]) for k, v in glob.items()}


for name, case in spec["cases"].items():
    model = CLIPModel(**spec["fields"])
    model.load_state_dict(state)
    rec = {}
    if case["kind"] == "forward":
        mesh = make_mesh(-1, 1, case["pp"])
        b = local_rows("fwd", mesh)
        with torch.no_grad():
            rec["tokens"] = pp_image_tokens(model, b["image"], mesh, case["micro"])
            rec["hidden"] = pp_text_feature(model, b["input_ids"],
                                            b["attention_mask"], mesh,
                                            case["micro"])
        if case.get("grad"):
            tok = pp_image_tokens(model, b["image"], mesh, case["micro"])
            hid = pp_text_feature(model, b["input_ids"], b["attention_mask"],
                                  mesh, case["micro"])
            n, d = tok.shape[0], mesh.data_rank
            g_tok, g_hid = (torch.from_numpy(data[k][d * n:(d + 1) * n])
                            for k in ("cot_tok", "cot_hid"))
            loss = (tok * g_tok).sum() + (hid * g_hid).sum()
            loss.backward()
            reduce_model_gradients(model, mesh)
            rec["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    else:
        cfg = config.update_cfg(clip_config.task_cfg_init_fn, None, case["argv"],
                                preprocess_fn=clip_config.update_clip_config,
                                target=config.new_base_cfg())
        runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
        rec["losses"] = []
        for step in range(case["steps"]):
            m = runner.batch_processor(local_rows(f"{case['data']}_{step}",
                                                  runner.mesh))
            rec["losses"].append(float(m["loss"]))
            runner.step += 1
        rec["full"] = full_state_dict(runner.model)
    torch.save(rec, f"{out}/{name}_{r}.pt")
print("WORKER_DONE", r, flush=True)
'''

BATCH = 8
STEP_COUNT = 2
# name -> (world, case)
CASES = {
    **{f"fwd_pp2_m{m}": (2, {"kind": "forward", "pp": 2, "micro": m,
                             "grad": m == 2}) for m in (1, 2, 4)},
    **{f"fwd_pp4_m{m}": (4, {"kind": "forward", "pp": 4, "micro": m,
                             "grad": m == 4}) for m in (1, 2, 4)},
    "step_pp2": (2, {"kind": "step", "argv": ["dist.pp_size=2",
                                              "dist.pp_micro=2"], "steps": 2}),
    "step_pp4": (4, {"kind": "step", "argv": ["dist.pp_size=4",
                                              "dist.pp_micro=2"], "steps": 2}),
    "step_pp2_zero1": (4, {"kind": "step", "argv": [
        "dist.pp_size=2", "dist.pp_micro=2", "dist.zero1=True"], "steps": 2}),
    "step_pp2_fsdp": (4, {"kind": "step", "argv": [
        "dist.pp_size=2", "dist.pp_micro=2", "dist.fsdp=True"], "steps": 2}),
}


def _batches():
    out = {f"fwd_{k}": v for k, v in _batch(BATCH, 1).items()}
    rng = np.random.default_rng(2)
    out["cot_tok"] = rng.normal(size=(BATCH, 17, 32)).astype(np.float32)
    out["cot_hid"] = rng.normal(size=(BATCH, 8, 32)).astype(np.float32)
    for s in range(STEP_COUNT):
        for k, v in _batch(BATCH, 40 + s).items():
            out[f"step_{s}_{k}"] = v
    return out


@pytest.fixture(scope="module")
def pp_worlds(tmp_path_factory):
    flax_model, params, port = _pair(**DEPTH4)
    batches = _batches()
    fields = {f: getattr(flax_model, f) for f in _FIELDS}

    # the directories made here: pytest makes its base directory at the
    # first mktemp, which two threads would race to make
    tmps = {w: tmp_path_factory.mktemp(f"pp{w}") for w in (2, 4)}

    def world_of(world):
        tmp = tmps[world]
        torch.save(port.state_dict(), tmp / "state.pt")
        np.savez(tmp / "batches.npz", **batches)
        cases = {}
        for name, (w, case) in CASES.items():
            if w == world:
                case = dict(case)
                if case["kind"] == "step":
                    case["argv"] = (TINY + DEPTH_ARGV + SGD + case["argv"]
                                    + [f"data.batch_size={BATCH}"])
                    case["data"] = "step"
                cases[name] = case
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({
            "state": str(tmp / "state.pt"), "batches": str(tmp / "batches.npz"),
            "fields": fields, "cases": cases}))
        run_world(world, WORKER, {"SPEC": str(spec), "OUT": str(tmp)})
        return tmp

    with ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(world_of, w) for w in (2, 4)}
        tmps = {w: job.result() for w, job in jobs.items()}
    return tmps, flax_model, params, batches


def _ranks(tmps, name):
    world = CASES[name][0]
    return [torch.load(tmps[world] / f"{name}_{r}.pt", weights_only=False)
            for r in range(world)]


FORWARDS = [n for n in CASES if n.startswith("fwd")]


@pytest.mark.parametrize("name", FORWARDS)
def test_pp_forward_matches_jax(pp_worlds, name):
    """Both towers' pipelined forwards on every rank against JAX's
    ``pp_image_tokens`` / ``pp_text_feature`` on a pp mesh of as many
    devices, with real padding in the text batch."""
    tmps, flax_model, params, batches = pp_worlds
    world, case = CASES[name]
    mesh = jax_make_mesh(jax.devices()[:world], pp_size=case["pp"])
    b = {k: jnp.asarray(batches[f"fwd_{k}"]) for k in KEYS}
    sb = shard_batch(b, mesh)
    micro = case["micro"]
    tokens = jax.jit(lambda p, im: jax_pp_image_tokens(
        flax_model, p, im, mesh, micro))(params, sb["image"])
    hidden = jax.jit(lambda p, i, a: jax_pp_text_feature(
        flax_model, p, i, a, mesh, micro))(params, sb["input_ids"],
                                           sb["attention_mask"])
    for rec in _ranks(tmps, name):
        np.testing.assert_allclose(rec["tokens"].numpy(), np.asarray(tokens),
                                   **TOL)
        np.testing.assert_allclose(rec["hidden"].numpy(), np.asarray(hidden),
                                   **TOL)


_JAX_GRAD = {}


def _jax_plain_grad(flax_model, params, batches):
    """``jax.grad`` of sum(tokens * G) + sum(hidden * H) through JAX's plain
    towers (JAX's own ``tests/test_pp.py:130`` holds its pipelined gradients
    to these); once per module."""
    if "grad" not in _JAX_GRAD:
        b = {k: jnp.asarray(batches[f"fwd_{k}"]) for k in KEYS}
        g_tok, g_hid = (jnp.asarray(batches[k]) for k in ("cot_tok", "cot_hid"))

        def loss(p):
            tok = flax_model.apply(p, b["image"],
                                   method=lambda m, im: m.image_encoder(im, True))
            hid = flax_model.apply(
                p, b["input_ids"], b["attention_mask"],
                method=lambda m, i, a: m.text_encoder(i, a, None, True))
            return jnp.sum(tok * g_tok) + jnp.sum(hid * g_hid)

        _JAX_GRAD["grad"] = flax_params_to_state_dict(jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss))(params)))
    return _JAX_GRAD["grad"]


@pytest.mark.parametrize("name", [n for n in FORWARDS if CASES[n][1]["grad"]])
def test_pp_gradients_match_jax(pp_worlds, name):
    """Every parameter's gradient through the schedule (each leaf from its
    own stage, summed over the world) against ``jax.grad`` of JAX's towers,
    on every rank, bit-equal across the ranks."""
    tmps, flax_model, params, batches = pp_worlds
    want = _jax_plain_grad(flax_model, params, batches)
    ranks = _ranks(tmps, name)
    for rec in ranks:
        for k, got in rec["grads"].items():
            w, a = want[k].numpy().ravel(), got.numpy().ravel()
            keys = _key_bias(k, w.size)
            if keys is not None:
                w, a = np.delete(w, keys), np.delete(a, keys)
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-6)
            np.testing.assert_allclose(a / scale, w / scale, rtol=0, atol=1e-4,
                                       err_msg=k)
        for k, v in rec["grads"].items():
            assert torch.equal(v, ranks[0]["grads"][k]), k


_JAX_STEPS = {}


def _jax_steps(flax_model, params, batches, world, pp):
    """JAX's losses and final parameters after ``STEP_COUNT`` SGD steps on a
    mesh of ``world`` devices, pipelined over ``pp`` stages (1: plain data
    parallelism); once per mesh."""
    if (world, pp) in _JAX_STEPS:
        return _JAX_STEPS[world, pp]
    _, ref_cfg = _trees(TINY + DEPTH_ARGV + SGD + [f"data.batch_size={BATCH}"])
    mesh = jax_make_mesh(jax.devices()[:world], pp_size=pp)
    tx, set_lr = jax_build_optimizer(ref_cfg, params)
    state = TrainState.create(params, tx)
    step = jax_make_train_step(flax_model, tx, set_lr, mesh=mesh, donate=False,
                               pp_micro=2)
    losses = []
    for s in range(STEP_COUNT):
        batch = {k: batches[f"step_{s}_{k}"] for k in KEYS}
        state, m = step(state, shard_batch(batch, mesh), None, LR)
        losses.append(float(m["loss"]))
    _JAX_STEPS[world, pp] = losses, flax_params_to_state_dict(
        jax.tree.map(np.asarray, state.params))
    return _JAX_STEPS[world, pp]


STEPS = [n for n in CASES if n.startswith("step")]


@pytest.mark.parametrize("name", STEPS)
def test_pp_step_matches_jax_and_data_parallelism(pp_worlds, name):
    """``CLIPRunner`` steps under ``dist.pp_size`` (with ZeRO-1 or FSDP over
    the stage's data ranks) against JAX's data-parallel step, and (pp 2,
    world 2) against JAX's pipelined step on a mesh of as many devices
    (JAX's own ``tests/test_pp.py:150, :189`` hold its pipelined steps,
    ZeRO-1's too, against data parallelism with these bars); every rank's
    parameters bit-equal."""
    tmps, flax_model, params, batches = pp_worlds
    world, case = CASES[name]
    ranks = _ranks(tmps, name)
    for other in ranks[1:]:
        assert other["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["full"].items():
            assert torch.equal(v, other["full"][k]), k
    meshes = [(1, 1)] + ([(2, 2)] if name == "step_pp2" else [])
    for jax_world, pp in meshes:
        losses, want = _jax_steps(flax_model, params, batches, jax_world, pp)
        np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
        for key, value in ranks[0]["full"].items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       rtol=3e-4, atol=1e-6, err_msg=key)
