"""PyTorch port (simseg_tpu_torch): the evals, the checkpoint and the
launcher over a gloo world of CPU processes, each against one process
(``tests/test_multiprocess.py``, ``tests/test_launch_signals.py`` and
``tests/test_preemption.py`` for the JAX package).

- ``tools/seg_evaluation.main`` at W = 2 (3 scenes: shards of 2 and 1)
  with an int8_static image tower: rank 0 calibrates and rank 1 takes its
  state (bit-equal), the float64 histograms summed: the mIoU and the
  per-class IoU of one process within 1e-9, calibrated on the same first
  image (``SIMSEG_CALIB_IMAGES=1``);
- ``tools/retrieval_evaluation.main`` with int8 towers at W = 2 on 5 rows
  (shards of 3 and 2) and at W = 3 on 2 rows (one shard empty): the table
  of one process within 1e-6;
- ``RetrievalEvalHook`` with ``data.single_eval: false`` at W = 2;
- a 2-rank run of ``python -m simseg_tpu_torch.launch`` resumed from rank
  0's checkpoint equal, bit for bit, to the uninterrupted run;
- ``init_distributed`` failing loudly; the launcher's exit codes, its
  ignored SIGINT, and SIGTERM: every rank checkpoints one agreed step and
  exits 0.

Every world runs under a time limit of its own and its ranks' collectives
time out (``SIMSEG_DIST_TIMEOUT``), so a deadlock fails the test.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from simseg_tpu_torch.checkpoint.native import LATEST, STATE_FILE
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.tokenizer import make_test_vocab
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.tools import retrieval_evaluation, seg_evaluation
from tests.test_torch_port_distributed import REPO, WORLD_LIMIT, run_world
from tests.test_torch_port_pair_data import WORDS, write_pair_set
from tests.test_torch_port_retrieval import YAML as RETRIEVAL_YAML
from tests.test_torch_port_seg_cli import TINY_YAML as SEG_YAML
from tests.test_train_cli import CLIP_YAML
from tools.seg_parity import build_fixture, make_parity_tokenizer

torch.set_num_threads(2)

EVAL_WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch.parallel import init_distributed, rank, world_size
init_distributed(device="cpu")
r, w = rank(), world_size()
spec = json.loads(os.environ["SPEC"])
out = {}
if "hook" in spec:
    from types import SimpleNamespace
    from simseg_tpu_torch.core.train_hooks import RetrievalEvalHook
    from simseg_tpu_torch.utils.collections import AttrDict
    data = np.load(spec["hook"])
    rows = np.array_split(np.arange(len(data["iid"])), w)[r]
    runner = SimpleNamespace(cfg=AttrDict(data=AttrDict(single_eval=False)),
                             outputs={}, state=AttrDict())
    hook = RetrievalEvalHook()
    hook.before_val_epoch(runner)
    for part in np.array_split(rows, 2):
        runner.outputs = {"image_emb": torch.from_numpy(data["img"][part]),
                          "text_emb": torch.from_numpy(data["txt"][part]),
                          "image_id": data["iid"][part],
                          "caption_id": data["cid"][part]}
        hook.after_val_step(runner)
    hook.after_val_epoch(runner)
    out["hook"] = runner.state.retrieval_summary
if "seg" in spec:
    os.chdir(spec["seg_cwd"])
    from simseg_tpu_torch.ops.quant import quant_layers
    from simseg_tpu_torch.tasks import seg_eval
    seen = {}
    inner = seg_eval.evaluate_benchmark
    def keep(loader, model, *a, **kw):
        result = inner(loader, model, *a, **kw)
        seen["scales"] = {n: m.x_absmax.tolist() for n, m in
                          quant_layers(model).items() if m.x_absmax is not None}
        seen["images"] = sum(len(b["image"]) for b in loader)
        return result
    seg_eval.evaluate_benchmark = keep
    from simseg_tpu_torch.tools import seg_evaluation
    seg_evaluation.evaluate_benchmark = keep
    iou, miou = seg_evaluation.main(spec["seg"])["pascal_voc"]
    out["seg"] = {"iou": iou.tolist(), "miou": miou, **seen}
if "retrieval" in spec:
    from simseg_tpu_torch.tools import retrieval_evaluation
    out["retrieval"] = retrieval_evaluation.main(spec["retrieval"])
print("EVAL:" + json.dumps(out), flush=True)
'''


def _eval_world(world, spec):
    outs = run_world(world, EVAL_WORKER,
                     {"SPEC": json.dumps(spec), "SIMSEG_DIST_TIMEOUT": "60",
                      "SIMSEG_CALIB_IMAGES": "1"})
    return [json.loads([line for line in o.splitlines()
                        if line.startswith("EVAL:")][0][5:]) for o in outs]


@pytest.fixture(scope="module")
def seg_fixture(tmp_path_factory):
    """3 VOC-layout scenes, a tiny CLIP .pth, its config, vocab and label
    bank (``tests/test_torch_port_seg_cli.py:tiny``)."""
    root = str(tmp_path_factory.mktemp("seg"))
    classes = build_fixture(root, 3, 8, 0, 288)[0]
    tok = make_parity_tokenizer(classes)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")
    yaml_path = os.path.join(root, "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write(SEG_YAML.format(root=root))
    os.makedirs(os.path.join(root, "data", "label_category"))
    with open(os.path.join(root, "data", "label_category", "pascal_voc.txt"),
              "w") as f:
        f.write("\n".join(classes) + "\n")
    cfg = update_cfg(task_cfg_init_fn, yaml_path, target=new_base_cfg())
    torch.manual_seed(3)
    ckpt = os.path.join(root, "tiny.pth")
    torch.save({"state_dict": build_clip_model(cfg).state_dict()}, ckpt)
    argv = ["--cfg", yaml_path, "--ckpt_path", ckpt, "--vocab_file", vocab,
            "--device", "cpu", "model.image_encoder.arch={'quant': 'int8_static'}"]
    return root, argv


def test_seg_eval_over_two_ranks_equals_one_process(seg_fixture, monkeypatch):
    root, argv = seg_fixture
    ranks = _eval_world(2, {"seg": argv, "seg_cwd": root})
    monkeypatch.chdir(root)
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", "1")
    iou, miou = seg_evaluation.main(argv)["pascal_voc"]
    assert [r["seg"]["images"] for r in ranks] == [2, 1]
    assert ranks[0]["seg"]["scales"] and \
        ranks[1]["seg"]["scales"] == ranks[0]["seg"]["scales"]
    for r in ranks:
        assert abs(r["seg"]["miou"] - miou) <= 1e-9, (r["seg"]["miou"], miou)
        np.testing.assert_allclose(r["seg"]["iou"], iou, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def retrieval_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("retrieval")
    write_pair_set(tmp / "data", "f5", 0, 5, seed=8, parquet=True)
    write_pair_set(tmp / "data", "f2", 0, 2, seed=9, parquet=True)
    (tmp / "tiny.yaml").write_text(RETRIEVAL_YAML)
    (tmp / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    cfg = update_cfg(task_cfg_init_fn, str(tmp / "tiny.yaml"),
                     target=new_base_cfg())
    torch.manual_seed(5)
    torch.save({"state_dict": build_clip_model(cfg).state_dict()},
               tmp / "init.pth")
    return tmp


@pytest.mark.parametrize("world,name", [(2, "f5"), (3, "f2")])
def test_retrieval_cli_over_ranks_equals_one_process(retrieval_fixture, world,
                                                     name):
    """Uneven shards (3 and 2 rows; 1, 1 and 0 rows: rank 2's shard is
    empty and still joins the gather), int8 towers with rank 0's state."""
    tmp = retrieval_fixture
    argv = ["--cfg", str(tmp / "tiny.yaml"), "--ckpt_path", str(tmp / "init.pth"),
            "--vocab_file", str(tmp / "vocab.txt"), "--device", "cpu",
            f"data.valid_name=[{name}]", f"data.data_path={tmp}/data/",
            "data.batch_size_val=2",
            "model.image_encoder.arch={'quant': 'int8'}",
            "model.text_encoder.arch={'quant': 'int8'}"]
    ranks = _eval_world(world, {"retrieval": argv})
    want = retrieval_evaluation.main(argv)[name]
    for r in ranks:
        got = r["retrieval"][name]
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-6, (k, got[k], v)


def test_retrieval_hook_gathers_the_ranks_shards(tmp_path):
    """``single_eval: false`` at W = 2: each rank embeds its rows (the last
    one padding, id -1), the hook gathers, and both report the table of
    the whole set."""
    from simseg_tpu_torch.core.train_hooks import RetrievalEvalHook
    from simseg_tpu_torch.utils.collections import AttrDict
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    img = rng.normal(size=(9, 6)).astype(np.float32)
    txt = (img + 0.3 * rng.normal(size=(9, 6))).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    iid = np.array([0, 0, 1, 2, 2, 3, 4, 5, -1])
    cid = np.array([0, 1, 2, 3, 4, 5, 6, 7, -1])
    np.savez(tmp_path / "emb.npz", img=img, txt=txt, iid=iid, cid=cid)
    ranks = _eval_world(2, {"hook": str(tmp_path / "emb.npz")})
    runner = SimpleNamespace(cfg=AttrDict(data=AttrDict(single_eval=False)),
                             outputs={"image_emb": torch.from_numpy(img),
                                      "text_emb": torch.from_numpy(txt),
                                      "image_id": iid, "caption_id": cid},
                             state=AttrDict())
    hook = RetrievalEvalHook()
    hook.before_val_epoch(runner)
    hook.after_val_step(runner)
    hook.after_val_epoch(runner)
    want = runner.state.retrieval_summary
    for r in ranks:
        for k, v in want.items():
            assert abs(r["hook"][k] - v) <= 1e-6, (k, r["hook"][k], v)


# ------------------------------------------------------------ the launcher

def _train_fixture(tmp_path, n_train=16):
    write_pair_set(tmp_path / "data", "pairs", n_train, 2, seed=4)
    (tmp_path / "clip.yaml").write_text(CLIP_YAML)
    (tmp_path / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")


def _launch(tmp_path, ckpt, *extra, nproc=2, cfg=None):
    cmd = [sys.executable, "-m", "simseg_tpu_torch.launch", "--task", "clip",
           "--nproc_per_node", str(nproc),
           "--cfg", str(cfg or tmp_path / "clip.yaml"),
           "--vocab_file", str(tmp_path / "vocab.txt"), "--device", "cpu",
           f"data.data_path={tmp_path}/data/", "data.train_name=[pairs]",
           "data.enable_valid=False", f"ckpt.dir={tmp_path}/{ckpt}", *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               SIMSEG_DIST_TIMEOUT="60")
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen(cmd, cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc, limit=WORLD_LIMIT):
    try:
        out = proc.communicate(timeout=limit)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out


def _model_state(directory, name=None):
    if name is None:
        name = (directory / LATEST).read_text().strip()
    return torch.load(directory / name / STATE_FILE, weights_only=True)


def test_two_rank_run_resumed_from_rank_zero_checkpoint_is_bit_equal(tmp_path):
    """Epoch 1 over 2 ranks (2 steps of 8), then fresh ranks resume from
    rank 0's checkpoint for epoch 2: the parameters, the optimizer state
    and the step equal the uninterrupted 2-epoch run's, bit for bit."""
    _train_fixture(tmp_path)
    rc, out = _finish(_launch(tmp_path, "cut", "epoch=1"))
    assert rc == 0, out[-3000:]
    rc, out = _finish(_launch(tmp_path, "cut", "epoch=2"))
    assert rc == 0, out[-3000:]
    assert "Auto-resumed at epoch 1, step 2" in out
    assert os.path.exists(tmp_path / "output" / "clip_log.txt")
    rc, out2 = _finish(_launch(tmp_path, "whole", "epoch=2"))
    assert rc == 0, out2[-3000:]
    cut = _model_state(tmp_path / "cut" / "toytrain", "epoch_002")
    whole = _model_state(tmp_path / "whole" / "toytrain", "epoch_002")
    assert cut["step"] == whole["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(cut["model"][k], v), k
    for k, v in whole["optimizer"]["base"]["state"].items():
        for name, t in v.items():
            assert torch.equal(cut["optimizer"]["base"]["state"][k][name], t)


HALF_SET = r'''
import os, sys
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch.parallel import init_distributed
init_distributed(device="cpu", timeout=3)
'''


@pytest.mark.parametrize("env,message", [
    ({"RANK": "0", "WORLD_SIZE": "2"}, "half set: LOCAL_RANK, MASTER_ADDR, "
                                       "MASTER_PORT missing"),
    ({"RANK": "1", "LOCAL_RANK": "1", "WORLD_SIZE": "2",
      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "free"},
     "init_process_group('gloo') failed"),
])
def test_init_distributed_fails_loudly(env, message):
    """A half-set environment, and a world of 2 whose rank 0 never comes,
    raise: no rank carries on as a single process."""
    from tests.test_torch_port_distributed import free_port

    full = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                         "MASTER_PORT")}
    full.update(env, REPO=REPO)
    if full.get("MASTER_PORT") == "free":
        full["MASTER_PORT"] = str(free_port())
    r = subprocess.run([sys.executable, "-c", HALF_SET], env=full,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert message in r.stderr, r.stderr[-2000:]


def _children(pid):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(p) for p in f.read().split()]
    except OSError:
        return []


def _wait_children(proc, n=2, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        kids = _children(proc.pid)
        if len(kids) >= n:
            return kids
        if proc.poll() is not None:
            raise AssertionError(f"launcher exited rc={proc.returncode} "
                                 "before its ranks started")
        time.sleep(0.05)
    raise AssertionError("the launcher never started its ranks")


def _wait_steps(proc, log, steps, timeout=120.0):
    """Waits until rank 0's tee'd log shows ``steps`` step lines."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if log.exists() and log.read_text().count("Epoch [") >= steps:
            return
        if proc.poll() is not None:
            raise AssertionError(f"the run ended early, rc={proc.returncode}")
        time.sleep(0.2)
    raise AssertionError("the run never logged its steps")


def test_launcher_returns_a_ranks_exit_code(tmp_path):
    _train_fixture(tmp_path)
    rc, out = _finish(_launch(tmp_path, "x", cfg=tmp_path / "missing.yaml"))
    assert rc == 1, out[-2000:]


def test_launcher_launches_the_probe_and_refuses_more_ranks_than_cards(tmp_path):
    _train_fixture(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    # nothing waits any more: --task linear_prob launches its entry point,
    # whose rank fails on the missing config with its own exit code
    r = subprocess.run([sys.executable, "-m", "simseg_tpu_torch.launch",
                        "--task", "linear_prob", "--cfg", "x.yaml",
                        "--device", "cpu"], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
    assert "simseg_tpu_torch.tasks.linear_prob.train" in r.stdout
    r = subprocess.run([sys.executable, "-m", "simseg_tpu_torch.launch",
                        "--nproc_per_node", str(torch.cuda.device_count() + 1),
                        "--cfg", "x.yaml"], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "one rank per card" in r.stderr


def test_launcher_ignores_sigint_and_reports_128_plus_sig(tmp_path):
    """SIGINT aimed at the launcher alone leaves it running; a rank killed
    by SIGKILL makes it kill the other rank and exit 137."""
    _train_fixture(tmp_path)
    proc = _launch(tmp_path, "sig", "epoch=100")
    try:
        kids = _wait_children(proc)
        time.sleep(0.5)
        os.kill(proc.pid, signal.SIGINT)
        time.sleep(1.0)
        assert proc.poll() is None, "the launcher died on SIGINT"
        os.kill(kids[1], signal.SIGKILL)
        rc, out = _finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 128 + signal.SIGKILL, out[-2000:]
    assert all(proc_gone(k) for k in kids)


def proc_gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] == "Z"
    except OSError:
        return True


def test_sigterm_through_the_launcher_checkpoints_one_step(tmp_path):
    """SIGTERM to the launcher mid-run: it reaches both ranks, they agree on
    the step, rank 0 writes the step checkpoint, all exit 0, and a restart
    resumes at that step."""
    _train_fixture(tmp_path)
    proc = _launch(tmp_path, "pre", "epoch=100")
    try:
        _wait_steps(proc, tmp_path / "output" / "clip_log.txt", 3)
        proc.send_signal(signal.SIGTERM)
        rc, out = _finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, out[-3000:]
    assert "Preemption checkpoint written" in out, out[-3000:]
    directory = tmp_path / "pre" / "toytrain"
    step = _model_state(directory)["step"]
    assert step >= 3
    assert f"step {step}: exiting" in out
    rc, out = _finish(_launch(tmp_path, "pre", "epoch=1"))
    assert rc == 0, out[-3000:]
    assert f"step {step}" in out.split("Auto-resumed at epoch")[1].splitlines()[0]
