"""PyTorch port (simseg_tpu_torch): the orbax checkpoint backend
(``checkpoint/native.py``, on ``torch.distributed.checkpoint``) against
JAX's orbax functions (``simseg_tpu/checkpoint/native.py:193-267``).

The same schedule of saves on both, from the same weights (the tiny
CLIP's, carried across by the converter, moved before every save): steps
2, 4, 6 and 8, then a second save at step 8 with a newer meta. The same
steps remain (orbax's ``max_to_keep`` 3; the re-saved step replaced); the
same meta is read back; a restore at step 6 and at the latest step gives
the weights saved there in both packages, bit for bit, and the port's
optimizer state saved there. A step directory whose write never ended is
not taken as the latest. ``load_pretrained_params`` reads such a
directory's weights (JAX's ``_looks_like_orbax_dir``).
"""

import copy
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from simseg_tpu.checkpoint.native import load_checkpoint_orbax as jax_load
from simseg_tpu.checkpoint.native import make_orbax_manager as jax_manager
from simseg_tpu.checkpoint.native import save_checkpoint_orbax as jax_save
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu_torch.checkpoint import load_pretrained_params
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.checkpoint.native import (ORBAX_META, complete_steps,
                                                load_checkpoint_orbax,
                                                make_orbax_manager,
                                                save_checkpoint_orbax)
from simseg_tpu_torch.core.optim import build_optimizer
from simseg_tpu_torch.models.clip import CLIPModel
from tests.test_torch_port_train import _FIELDS, TINY, _pair, _trees

torch.set_num_threads(2)

SCHEDULE = [2, 4, 6, 8, 8]
ADAMW = ["optim.name=torch.optim.AdamW", "optim.lr.init=1e-3"]


def _meta(i, step):
    # the re-save at step 8 is an epoch-end save: the epoch after, inner 0
    return {"epoch": i, "step": step, "inner_step": 0 if i == 4 else 3,
            "wandb_id": None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages through the schedule; what each saved at each step."""
    tmp = tmp_path_factory.mktemp("orbax")
    flax_model, params, port = _pair()
    fields = {f: getattr(flax_model, f) for f in _FIELDS}
    cfg, _ = _trees(TINY + ADAMW)
    opt = build_optimizer(cfg, port)
    jmgr = jax_manager(str(tmp / "jax"))
    pmgr = make_orbax_manager(str(tmp / "port"))
    tx = optax.adamw(1e-3)
    saved = {}
    for i, step in enumerate(SCHEDULE):
        params = jax.tree.map(lambda a: np.asarray(a + 0.01, np.float32), params)
        jstate = TrainState.create(params, tx)
        # moments that move between saves, then the weights JAX saves
        for p in port.parameters():
            p.grad = torch.full_like(p, 0.1 * (i + 1))
        opt.set_lr(1e-3)
        opt.step()
        port.load_state_dict(flax_params_to_state_dict(params))
        jax_save(jmgr, step, jstate, _meta(i, step))
        save_checkpoint_orbax(pmgr, step, port, opt, _meta(i, step))
        saved[step] = (copy.deepcopy(port.state_dict()),
                       copy.deepcopy(opt.state_dict()), _meta(i, step))
    jmgr.wait_until_finished()
    pmgr.wait_until_finished()
    return tmp, jmgr, pmgr, jstate, fields, cfg, saved


def test_the_same_steps_remain(runs):
    _, jmgr, pmgr, *_ = runs
    assert list(jmgr.all_steps()) == pmgr.all_steps() == [4, 6, 8]
    assert pmgr.latest_step() == jmgr.latest_step() == 8


@pytest.mark.parametrize("step", [6, None])
def test_a_restore_gives_what_was_saved_there(runs, step):
    """At step 6 and at the latest (8, the re-save's): JAX's and the port's
    meta equal and equal to the save's; the port's weights and optimizer
    state bit-equal to what it saved, and to JAX's restored weights."""
    _, jmgr, pmgr, jstate, fields, cfg, saved = runs
    restored, jmeta = jax_load(jmgr, jstate, step=step)
    model = CLIPModel(**fields)
    opt = build_optimizer(cfg, model)
    meta = load_checkpoint_orbax(pmgr, model, opt, step=step)
    want_state, want_opt, want_meta = saved[step or 8]
    assert meta == jmeta == want_meta
    ref = flax_params_to_state_dict(jax.tree.map(np.asarray, restored.params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_state[k]), k
        assert torch.equal(v, ref[k]), k
    got = opt.state_dict()
    assert got["base"]["param_groups"] == want_opt["base"]["param_groups"]
    for i, st in want_opt["base"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["base"]["state"][i][k], v), (i, k)


def test_an_unfinished_step_is_not_the_latest(runs, tmp_path):
    """A copy of the directory with a step 10 whose ``meta.json`` was never
    written (a write cut short): the latest step is still 8."""
    tmp, _, _, _, fields, cfg, saved = runs
    copy_dir = tmp_path / "cut"
    shutil.copytree(tmp / "port", copy_dir)
    shutil.copytree(copy_dir / "8", copy_dir / "10")
    os.remove(copy_dir / "10" / ORBAX_META)
    assert complete_steps(str(copy_dir)) == [4, 6, 8]
    mgr = make_orbax_manager(str(copy_dir))
    model = CLIPModel(**fields)
    assert load_checkpoint_orbax(mgr, model)["step"] == 8


def test_pretrained_params_read_the_step_directories(runs):
    """``load_pretrained_params`` on the directory (numeric step
    directories, no ``latest_ckpt``): the latest step's weights."""
    tmp, _, _, _, fields, _, saved = runs
    model = load_pretrained_params(str(tmp / "port"), CLIPModel(**fields))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[8][0][k]), k


def test_an_update_after_the_save_does_not_reach_it(tmp_path, monkeypatch):
    """The save returns once its snapshot is taken; the write is held back
    until the parameters have been changed in place (as the next
    optimizer step changes them): the step holds the values of the save."""
    import threading
    from concurrent.futures import Future

    import torch.distributed.checkpoint as dcp

    gate, real = threading.Event(), dcp.async_save

    def held(*args, **kwargs):
        future = Future()

        def run():
            gate.wait()
            try:
                future.set_result(real(*args, **kwargs).result())
            except BaseException as e:
                future.set_exception(e)
        threading.Thread(target=run, daemon=True).start()
        return future

    monkeypatch.setattr(dcp, "async_save", held)
    flax_model, params, port = _pair()
    want = copy.deepcopy(port.state_dict())
    mgr = make_orbax_manager(str(tmp_path / "ck"))
    save_checkpoint_orbax(mgr, 1, port, None, {"step": 1})
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
    gate.set()
    mgr.wait_until_finished()
    fresh = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS})
    load_checkpoint_orbax(mgr, fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_resume_mid_accumulation_equals_uninterrupted(tmp_path):
    """``tests/test_torch_port_train.py``'s resume halfway through an
    accumulation window (``optim.grad_accum_steps=2``, a save after step
    3) under ``ckpt.backend=orbax``: the accumulation mean and mini-step
    come back with the AdamW state, and the resumed run's parameters equal
    the uninterrupted run's. The cut run's write is joined before the
    resume, as a run whose write had drained before it stopped."""
    from simseg_tpu_torch.core.train_hooks import CheckpointHook
    from tests.test_torch_port_train import _batches, _Record, _runner

    argv = ["data.train_steps=4", "epoch=1", "ckpt.step_interval=3",
            "optim.grad_accum_steps=2", "ckpt.backend=orbax"]
    whole, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'a'}"], _batches(4), _Record())
    whole.run()
    cut, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4),
                     _Record(stop_after=3))
    with pytest.raises(KeyboardInterrupt):
        cut.run()
    for hook in cut._hooks:
        if isinstance(hook, CheckpointHook):
            hook.wait()
    assert cut.optimizer.mini_step == 1
    hook = _Record()
    resumed, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4), hook)
    resumed.run()
    assert len(hook.lrs) == 1 and resumed.step == 4
    assert {int(s["step"]) for s in resumed.optimizer.base.state.values()} == {2}
    for (key, a), b in zip(whole.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_preemption_writes_the_step_and_waits_for_it(tmp_path):
    """SIGTERM during step 2 under ``ckpt.backend=orbax``: the preemption
    hook saves step 2 and joins the write before the run exits (JAX
    ``PreemptionHook``); a restarted run resumes there and ends equal to
    the uninterrupted run."""
    import signal

    from simseg_tpu_torch.core.hooks import Hook, Priority
    from tests.test_torch_port_train import _batches, _Record, _runner

    class Term(Hook):
        def after_train_step(self, runner):
            if runner.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    argv = ["data.train_steps=4", "epoch=1", "ckpt.backend=orbax"]
    whole, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'a'}"], _batches(4), _Record())
    whole.run()
    cut, cfg = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4), _Record())
    cut.register_hook(Term(), Priority.HIGHEST)
    with pytest.raises(SystemExit) as stop:
        cut.run()
    assert stop.value.code == 0
    assert complete_steps(cfg.ckpt.dir) == [2]
    resumed, _ = _runner(argv + [f"ckpt.dir={tmp_path / 'b'}"], _batches(4), _Record())
    resumed.run()
    assert resumed.step == 4
    for (key, a), b in zip(whole.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(a, b), key


FAILING_WRITE = r'''
import concurrent.futures, json, os, sys, time
sys.path.insert(0, os.environ["REPO"])
import torch
import torch.distributed.checkpoint as dcp
from simseg_tpu_torch.checkpoint.native import complete_steps, make_orbax_manager
from simseg_tpu_torch.parallel import init_distributed, rank
init_distributed(device="cpu", timeout=int(os.environ["TIMEOUT"]))
out = os.environ["OUT"]
mgr = make_orbax_manager(out)
items = {f"model/w{rank()}": torch.full((4,), float(rank()))}
mgr.save(1, items, {"step": 1})
mgr.wait_until_finished()
real = dcp.async_save

def failing(*args, **kwargs):
    future = concurrent.futures.Future()
    future.set_exception(OSError("no space left on device"))
    return future

if rank() == 1:
    dcp.async_save = failing
mgr.save(2, items, {"step": 2})
t0 = time.perf_counter()
try:
    mgr.wait_until_finished()
    raised = None
except RuntimeError as e:
    raised = repr(e.__cause__)
waited = time.perf_counter() - t0
after_failure = complete_steps(out)
dcp.async_save = real
mgr.save(3, items, {"step": 3})
mgr.wait_until_finished()
print("RESULT", json.dumps({"rank": rank(), "raised": raised, "waited": waited,
                            "after_failure": after_failure,
                            "end": complete_steps(out)}), flush=True)
'''


def test_a_write_failing_on_one_rank_fails_on_every_rank(tmp_path):
    """Two gloo ranks; rank 1's write of step 2 fails (its ``async_save``
    future raises): both ranks' ``wait_until_finished`` raise at once, far
    inside the world's collective timeout (rank 1 its own error, rank 0
    that another rank's write failed), step 2 stays incomplete, and the
    next save completes on both."""
    import json

    from tests.test_torch_port_distributed import run_world

    timeout = 60
    outs = run_world(2, FAILING_WRITE, {"OUT": str(tmp_path),
                                        "TIMEOUT": str(timeout)})
    results = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        r = json.loads(line[len("RESULT "):])
        results[r["rank"]] = r
    assert "no space left on device" in results[1]["raised"]
    assert "another rank's write of step 2 failed" in results[0]["raised"]
    for r in results.values():
        assert r["waited"] < timeout / 4, r
        assert r["after_failure"] == [1], r
        assert r["end"] == [1, 3], r
