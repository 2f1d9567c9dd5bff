"""PyTorch port (simseg_tpu_torch): retrieval metrics, the retrieval hook
and the retrieval-eval CLI against the JAX package's
(``simseg_tpu/utils/retrieval.py``, ``core/train_hooks.py:RetrievalEvalHook``,
``tools/retrieval_evaluation.py``).

Bars: R@k and RSUM within 1e-6 (ranks equal; the tables are counts over
counts). Embeddings from the same weights in float32 on both sides: a rank
moves only where two scores tie within float32 noise, which seeded
embeddings do not give.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.core.train_hooks as jax_hooks
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.data.datasets import DataLoader as JaxLoader
from simseg_tpu.data.datasets import ParquetRetrievalDataset as JaxParquet
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from simseg_tpu.data.transforms import build_transforms as jax_build_transforms
from simseg_tpu.models.clip import build_clip_model as jax_build_clip_model
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu.tasks.clip.config import update_clip_config as jax_update_clip_config
from simseg_tpu.utils.collections import AttrDict as JaxAttrDict
from simseg_tpu.utils.retrieval import retrieval_summary as jax_retrieval_summary
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.core.train_hooks import RetrievalEvalHook
from simseg_tpu_torch.tools import retrieval_evaluation
from simseg_tpu_torch.utils.collections import AttrDict
from simseg_tpu_torch.utils.retrieval import (IndexedEmb, first_match_ranks,
                                              retrieval_summary)
from tests.test_torch_port_pair_data import WORDS, write_pair_set

torch.set_num_threads(2)

TOL = 1e-6


def _embeddings(seed, n_images, per_image, dim=16, pad=0):
    """Unit embeddings of n_images images with per_image captions each
    (image rows repeated per caption, as the loader gives them), a few
    images with one caption more, text near its image, and ``pad`` rows of
    id -1 at the end."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_images, dim))
    iid = np.repeat(np.arange(n_images), per_image)
    iid = np.concatenate([iid, np.arange(0, n_images, 5)])
    img = base[iid] + 0.01 * rng.normal(size=(len(iid), dim))
    txt = base[iid] + 0.8 * rng.normal(size=(len(iid), dim))
    cid = np.arange(len(iid)) + 1000
    if pad:
        img = np.concatenate([img, rng.normal(size=(pad, dim))])
        txt = np.concatenate([txt, rng.normal(size=(pad, dim))])
        iid = np.concatenate([iid, np.full(pad, -1)])
        cid = np.concatenate([cid, np.full(pad, -1)])
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return unit(img), unit(txt), iid.astype(np.int64), cid.astype(np.int64)


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), k


@pytest.mark.parametrize("n_images,per_image", [(7, 1), (40, 5), (130, 2)])
def test_retrieval_summary_matches_jax(n_images, per_image):
    img, txt, iid, cid = _embeddings(n_images, n_images, per_image)
    want = jax_retrieval_summary(img, txt, iid, cid)
    _close(retrieval_summary(img, txt, iid, cid), want)
    # tensors stay on their device, ids may come as tensors
    _close(retrieval_summary(torch.from_numpy(img), torch.from_numpy(txt),
                             torch.from_numpy(iid), cid), want)
    assert 0 < want["rsum"] < 600


def test_first_match_ranks_in_chunks_and_without_a_match():
    img, txt, iid, _ = _embeddings(3, 50, 2)
    left = IndexedEmb("t", iid, torch.from_numpy(txt))
    right = IndexedEmb("i", iid, torch.from_numpy(img)).unique()
    whole = first_match_ranks(left, right)
    np.testing.assert_array_equal(first_match_ranks(left, right, batch=7), whole)
    # the argsort rule in float64, over the last embedding of each id
    assert right.group_idx.tolist() == sorted(set(iid.tolist()))
    last = [int(np.flatnonzero(iid == g)[-1]) for g in right.group_idx]
    np.testing.assert_array_equal(right.emb.numpy(), img[last])
    sim = txt.astype(np.float64) @ img[last].astype(np.float64).T
    order = np.argsort(-sim, axis=1, kind="stable")
    np.testing.assert_array_equal(
        whole, [int(np.flatnonzero(right.group_idx[o] == g)[0])
                for o, g in zip(order, iid)])
    stranger = IndexedEmb("t", np.array([999]), torch.from_numpy(txt[:1]))
    assert first_match_ranks(stranger, right).tolist() == [-1]


def _hook_runner(attr_dict, cfg):
    return types.SimpleNamespace(outputs={}, state=attr_dict(), cfg=cfg)


def test_retrieval_hook_drops_padding_rows_as_jax():
    """Batches with repeated image ids and -1 padding rows through both
    hooks: the same table, equal to the table of the kept rows."""
    img, txt, iid, cid = _embeddings(11, 30, 3, pad=5)
    cfg = JaxAttrDict(data=JaxAttrDict(single_eval=True))
    ours, ref = RetrievalEvalHook(), jax_hooks.RetrievalEvalHook()
    runners = (_hook_runner(AttrDict, cfg), _hook_runner(JaxAttrDict, cfg))
    ours.before_val_epoch(runners[0])
    ref.before_val_epoch(runners[1])
    for s in range(0, len(iid), 16):
        rows = slice(s, s + 16)
        runners[0].outputs = {"image_emb": torch.from_numpy(img[rows]),
                              "text_emb": torch.from_numpy(txt[rows]),
                              "image_id": iid[rows], "caption_id": cid[rows]}
        runners[1].outputs = {"image_emb": jnp.asarray(img[rows]),
                              "text_emb": jnp.asarray(txt[rows]),
                              "image_id": iid[rows], "caption_id": cid[rows]}
        ours.after_val_step(runners[0])
        ref.after_val_step(runners[1])
    ours.after_val_epoch(runners[0])
    ref.after_val_epoch(runners[1])
    want = runners[1].state.retrieval_summary
    _close(runners[0].state.retrieval_summary, want)
    keep = iid > -1
    _close(want, jax_retrieval_summary(img[keep], txt[keep], iid[keep], cid[keep]))


# ----------------------------------------------------------------- the CLI

YAML = """\
model:
  image_encoder:
    tag: vit_test
    embedding_dim: 32
  text_encoder:
    tag: bert_test
    embedding_dim: 32
  projection:
    name: simple
    dim: 16
  pool:
    name: loda
    loda:
      image_k: 3
      text_k: 1
  max_length: 12
loss:
  temperature:
    name: parameter
    value: 0.02
dist:
  bf16: False
transforms:
  input_size: 32
  resize:
    size: 32
  valid_transforms: [resize]
data:
  batch_size_val: 5
  num_workers: 1
  native_decode: False
"""


def _jax_tool():
    """``tools/retrieval_evaluation.py`` of the JAX package, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_retrieval_evaluation",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "tools", "retrieval_evaluation.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_retrieval_cli_matches_jax_evaluate_benchmark(tmp_path, quant):
    """The port's ``main(argv)`` over a parquet set (12 rows of 40-90-px
    JPEG and PNG images, two captions an image), with JAX's initial weights
    as a ``.pth``, against JAX's ``evaluate_benchmark`` on the same set and
    weights; with both towers int8, each side calibrates on its first
    batch."""
    write_pair_set(tmp_path / "data", "f30k", 0, 12, seed=8, parquet=True)
    (tmp_path / "tiny.yaml").write_text(YAML)
    from simseg_tpu_torch.data.tokenizer import make_test_vocab

    vocab = make_test_vocab(WORDS)
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    argv = ["data.valid_name=[f30k]", f"data.data_path={tmp_path}/data/"]
    if quant != "none":
        argv += [f"model.image_encoder.arch={{'quant': '{quant}'}}",
                 f"model.text_encoder.arch={{'quant': '{quant}'}}"]
    jcfg = jax_update_cfg(jax_task_cfg_init_fn, str(tmp_path / "tiny.yaml"),
                          argv, preprocess_fn=jax_update_clip_config,
                          target=jax_new_base_cfg())
    model = jax_build_clip_model(jcfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32)}))
    torch.save({"state_dict": flax_params_to_state_dict(
        {"params": params["params"]})}, tmp_path / "init.pth")
    loader = JaxLoader(JaxParquet(jcfg, "f30k", JaxTokenizer(dict(vocab)),
                                  jax_build_transforms(jcfg, "valid")),
                       jcfg.data.batch_size_val, num_workers=1)
    want = _jax_tool().evaluate_benchmark(loader, model, params, jcfg)
    got = retrieval_evaluation.main(
        ["--cfg", str(tmp_path / "tiny.yaml"), "--ckpt_path",
         str(tmp_path / "init.pth"), "--vocab_file", str(tmp_path / "vocab.txt"),
         "--device", "cpu"] + argv)
    assert list(got) == ["f30k"]
    _close(got["f30k"], want)


def test_retrieval_cli_needs_a_vocab_file(tmp_path):
    (tmp_path / "tiny.yaml").write_text(YAML)
    with pytest.raises(RuntimeError, match="Cannot build tokenizer.*vocab_file"):
        retrieval_evaluation.main(["--cfg", str(tmp_path / "tiny.yaml"),
                                   "--device", "cpu"])
