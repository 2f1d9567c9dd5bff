"""PyTorch port (simseg_tpu_torch): the profile and wandb hooks through the
pretraining entry point (``tasks/clip/train.main(argv)`` on the CPU, the
tiny config of ``tests/test_train_cli.py:CLIP_YAML``), and the HuggingFace
branch of ``build_tokenizer`` against JAX's.

- ``cfg.profile``: a ``torch.profiler`` trace of the configured window of
  steps, written where JAX's hook writes its own (``dir``, default
  ``<ckpt.dir>/trace``), also when the run ends inside the window;
- ``wandb.enable``: against a stub ``wandb`` module in ``sys.modules``:
  ``init``'s arguments (project, entity, the id, ``resume="allow"``, the
  config), the logged keys and steps, the retrieval summary after
  validation, ``finish``; a resumed run passes the id its checkpoint
  kept; without wandb the run trains, and warns;
- the tokenizer: a BERT vocabulary directory the test writes, read through
  ``transformers`` offline by both packages, ids equal; the WordPiece path
  where nothing resolves or ``transformers`` is missing, as JAX's.
"""

import json
import logging
import os
import sys
import types
import unittest.mock

import pytest
import torch

from simseg_tpu.data.tokenizer import build_tokenizer as jax_build_tokenizer
from simseg_tpu_torch.data.tokenizer import (WordPieceTokenizer, build_tokenizer,
                                             make_test_vocab)
from simseg_tpu_torch.tasks.clip import train as port_train
from tests.test_torch_port_pair_data import CAPTIONS, WORDS, write_pair_set
from tests.test_train_cli import CLIP_YAML

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("hooks")
    write_pair_set(root / "data", "pairs", 48, 6, seed=17)
    (root / "clip.yaml").write_text(CLIP_YAML)
    (root / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    return root


def _argv(root, out, *extra, steps=4, valid=False):
    return ["--cfg", str(root / "clip.yaml"), "--vocab_file",
            str(root / "vocab.txt"), "--device", "cpu",
            f"data.data_path={root}/data/", f"ckpt.dir={out}",
            "data.train_name=[pairs]", "data.valid_name=[pairs]",
            f"data.enable_valid={valid}", f"data.train_steps={steps}",
            "ckpt.step_interval=-1", "log.interval_train=1", *extra]


def _main(argv, profile=None):
    """main(argv), with ``cfg.profile`` set on the tree as JAX's users set
    it (it is no key of the config files)."""
    init = port_train.task_cfg_init_fn

    def init_with_profile(cfg):
        init(cfg)
        if profile is not None:
            cfg.profile = profile

    with unittest.mock.patch.object(port_train, "task_cfg_init_fn",
                                    init_with_profile):
        return port_train.main(argv)


# ----------------------------------------------------------------- profile

@pytest.mark.parametrize("case", ["window", "default_dir", "past_the_end"])
def test_profile_hook_traces_the_window(fixture, tmp_path, case):
    trace_dir = tmp_path / "traces"
    profile = {"window": {"start_step": 1, "num_steps": 2,
                          "dir": str(trace_dir)},
               "default_dir": {"start_step": 0, "num_steps": 1},
               "past_the_end": {"start_step": 3, "num_steps": 5,
                                "dir": str(trace_dir)}}[case]
    runner = _main(_argv(fixture, tmp_path / "out"), profile=profile)
    path = runner.state.profile_trace
    want_dir = (trace_dir if "dir" in profile
                else os.path.join(runner.cfg.ckpt.dir, "trace"))
    first = profile["start_step"]
    last = min(first + profile["num_steps"], 4) - 1
    assert path == os.path.join(want_dir, f"trace_{first}-{last}.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the window's steps ran their products and the optimizer under it
    assert any(n.startswith("aten::") and "mm" in n for n in names)
    assert any("Optimizer" in n or "aten::add" in n for n in names)


# ------------------------------------------------------------------- wandb

class _StubRun:
    def __init__(self, kwargs):
        self.kwargs = kwargs
        self.id = kwargs.get("id") or "stub-run-1"
        self.logged = []
        self.finished = False

    def log(self, metrics, step=None):
        self.logged.append((step, dict(metrics)))

    def finish(self):
        self.finished = True


@pytest.fixture
def stub_wandb(monkeypatch):
    runs = []
    module = types.ModuleType("wandb")

    def init(**kwargs):
        runs.append(_StubRun(kwargs))
        return runs[-1]

    module.init = init
    monkeypatch.setitem(sys.modules, "wandb", module)
    return runs


def test_wandb_hook_logs_the_run_and_resumes_its_id(fixture, tmp_path,
                                                    stub_wandb):
    out = tmp_path / "out"
    extra = ("wandb.enable=True", "wandb.project=proj", "wandb.entity=team",
             "runner.val_interval_steps=2", "ckpt.step_interval=2")
    runner = _main(_argv(fixture, out, *extra, steps=4, valid=True))
    [run] = stub_wandb
    kw = run.kwargs
    assert (kw["project"], kw["entity"], kw["id"], kw["resume"]) == (
        "proj", "team", None, "allow")
    assert kw["config"] == runner.cfg.to_dict()
    keys = set(runner.cfg.wandb.train_record_keys)
    train_logs = [(s, m) for s, m in run.logged if set(m) <= keys]
    assert [s for s, _ in train_logs] == [1, 2, 3, 4]
    assert all(set(m) == {"loss", "i2t_acc", "t2i_acc", "lr"}
               for _, m in train_logs)
    summaries = [(s, m) for s, m in run.logged if "rsum" in m]
    assert [s for s, _ in summaries] == [2, 4]
    assert summaries[-1][1] == dict(runner.state.retrieval_summary)
    assert run.finished
    # a resumed run continues the same wandb run: the id from the meta
    resumed = _main(_argv(fixture, out, *extra, steps=6, valid=True))
    assert stub_wandb[1].kwargs["id"] == "stub-run-1"
    assert resumed.state.wandb_id == "stub-run-1" and stub_wandb[1].finished


def test_wandb_hook_without_wandb_warns_and_trains(fixture, tmp_path,
                                                   monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    with caplog.at_level(logging.WARNING):
        runner = _main(_argv(fixture, tmp_path / "out", "wandb.enable=True",
                             steps=2))
    assert runner.step == 2
    assert "wandb not installed" in caplog.text


# --------------------------------------------------------------- tokenizer

def _bert_dir(tmp_path):
    d = tmp_path / "bert_vocab"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
         "model_max_length": 512}))
    return d


def test_build_tokenizer_takes_the_local_hf_directory_as_jax(tmp_path):
    pytest.importorskip("transformers")
    d = _bert_dir(tmp_path)
    port = build_tokenizer("bert-base-uncased", local_dir=str(d))
    ref = jax_build_tokenizer("bert-base-uncased", local_dir=str(d))
    assert type(port) is type(ref) and not isinstance(port, WordPieceTokenizer)
    kw = dict(padding="max_length", truncation=True, max_length=12)
    assert port(CAPTIONS, **kw)["input_ids"] == ref(CAPTIONS, **kw)["input_ids"]
    # the same vocabulary through the port's WordPiece gives the same ids
    assert port(CAPTIONS, **kw)["input_ids"] == WordPieceTokenizer.from_vocab_file(
        str(d / "vocab.txt"))(CAPTIONS, **kw)["input_ids"]


@pytest.mark.parametrize("case", ["unresolved", "no_transformers", "nothing"])
def test_build_tokenizer_falls_back_as_jax(tmp_path, monkeypatch, case):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    if case == "no_transformers":
        monkeypatch.setitem(sys.modules, "transformers", None)
    missing = str(tmp_path / "no_such_dir")
    if case == "nothing":
        for build in (build_tokenizer, jax_build_tokenizer):
            with pytest.raises(RuntimeError, match="Cannot build tokenizer"):
                build("no/such-model", vocab_file=None, local_dir=missing)
        return
    port = build_tokenizer("no/such-model", vocab_file=str(vocab),
                           local_dir=missing)
    ref = jax_build_tokenizer("no/such-model", vocab_file=str(vocab),
                              local_dir=missing)
    assert isinstance(port, WordPieceTokenizer)
    kw = dict(padding="max_length", truncation=True, max_length=12)
    assert port(CAPTIONS, **kw) == ref(CAPTIONS, **kw)


@pytest.mark.parametrize("cached", [True, False])
def test_build_tokenizer_asks_the_hf_cache_for_a_cached_tag(tmp_path, monkeypatch,
                                                             cached):
    """A tag in the HF hub cache goes to ``AutoTokenizer.from_pretrained``
    offline, as JAX's does; a tag that is neither cached nor a directory
    goes straight to the WordPiece path."""
    transformers = pytest.importorskip("transformers")
    from huggingface_hub import constants

    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(tmp_path / "hub"))
    if cached:
        (tmp_path / "hub" / "models--org--some-bert").mkdir(parents=True)
    calls, sentinel = [], object()

    def from_pretrained(src, **kw):
        calls.append((src, kw))
        return sentinel

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        from_pretrained)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(make_test_vocab(WORDS)) + "\n")
    got = build_tokenizer("org/some-bert", vocab_file=str(vocab))
    if cached:
        assert got is sentinel
        assert calls == [("org/some-bert", {"local_files_only": True})]
    else:
        assert isinstance(got, WordPieceTokenizer) and calls == []
