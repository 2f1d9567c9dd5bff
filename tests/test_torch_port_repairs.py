"""PyTorch port (simseg_tpu_torch): faults of the port against the JAX
package, repaired, each with the test that shows it.

- ``SIMSEG_CALIB_IMAGES``: JAX's ``evaluate_benchmark`` calibrates an
  int8_static image tower on that many images
  (``simseg_tpu/tasks/seg_eval.py:399``); the port's now reads it too when
  no ``calib_images`` is given. Bars: both packages calibrate on the same
  8 images, each layer's calibration is JAX's on the same inputs, and the
  per-class IoU is equal.
- MixUpNCE's coefficient: the port's ``mixup_lambda`` is JAX's draw
  (``jax.random.beta`` on the folded step key) computed in numpy. Bar:
  within 1e-6 relative of JAX's over 256 (seed, step) pairs, with and
  without the step key, at three alphas (float32 log / exp / log1p ulps
  move a draw by about 1e-7; no draw here flips a rejection test).
- The BERT tower's cached-config lookup: ``resolve_bert_config`` takes
  JAX's order (``simseg_tpu/models/bert.py:207-245``): the tag table, a
  locally cached HuggingFace config, then the ``arch`` overrides. Bars: the
  same spec, or the same ``KeyError``, as JAX's for a saved ``BertConfig``
  directory with and without overrides, a saved non-BERT config, a missing
  path, a table tag, and each with ``transformers`` unimportable; the
  directory as ``model.text_encoder.tag`` builds JAX's text tower shapes.
- The logger's standard output: the port's ``utils.logger`` bound its
  handler to ``sys.stdout`` as it was when the module was first imported,
  where JAX's ``print``s to it as it is at each line; so a redirect or a
  capture made after the import lost every line. Bar: under
  ``contextlib.redirect_stdout`` after the import, both packages write the
  same line (the timestamp aside) to the redirect.
"""

import contextlib
import io
import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

import simseg_tpu.models.bert as jax_bert
import simseg_tpu.models.clip as jax_clip
import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.models.bert as port_bert
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.engine.train_step import mixup_lambda as jax_mixup_lambda
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch import config as port_config
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks.clip import config as port_clip_config
from simseg_tpu_torch.engine.train_step import mixup_lambda, step_key
from simseg_tpu_torch.utils import threefry
from tests.test_torch_port_lanes import CLASSES, WORDS, lane_models  # noqa: F401
from tests.test_torch_port_quant import replayed_calibration_matches_jax

torch.set_num_threads(1)

CALIB = 8


class _Loader:
    """Five batches of 2 at 32 px: calibration takes 4 of them."""

    batch_size = 2

    def __iter__(self):
        for seed in range(5):
            rng = np.random.default_rng(40 + seed)
            yield {"image": rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8),
                   "mask_label": rng.integers(0, len(CLASSES), (2, 40, 48)
                                              ).astype(np.int32),
                   "mask_h": [40] * 2, "mask_w": [48] * 2}


def test_calibration_count_from_the_environment(lane_models, monkeypatch):  # noqa: F811
    flax_model, params, port = lane_models
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4"], target=new_base_cfg())
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", str(CALIB))
    seen = {}

    def recorder(module, key):
        real = module.prepare_quant_params

        def record(*args, **kw):
            seen[key] = np.asarray(torch.as_tensor(kw["calib_images_u8"]))
            return real(*args, **kw)
        monkeypatch.setattr(module, "prepare_quant_params", record)

    recorder(jax_seg_eval, "jax")
    recorder(port_seg_eval, "port")
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        _Loader(), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = replayed_calibration_matches_jax(
        port, lambda: port_seg_eval.evaluate_benchmark(
            _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)),
            CLASSES, 4, "pascal_voc", input_size=32, bilateral_stride=4,
            max_length=12, device="cpu"), 1)
    assert seen["jax"].shape == (CALIB, 32, 32, 3)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou


def test_calibration_keyword_overrides_the_environment(lane_models,  # noqa: F811
                                                       monkeypatch):
    _, _, port = lane_models
    monkeypatch.setenv("SIMSEG_CALIB_IMAGES", str(CALIB))
    seen = {}
    real = port_seg_eval.prepare_quant_params

    def record(*args, **kw):
        seen["n"] = kw["calib_images_u8"].shape[0]
        return real(*args, **kw)

    monkeypatch.setattr(port_seg_eval, "prepare_quant_params", record)
    port_seg_eval.evaluate_benchmark(
        _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)), CLASSES,
        4, "pascal_voc", input_size=32, bilateral_stride=4, max_length=12,
        calib_images=3, device="cpu")
    assert seen["n"] == 3


def _pairs(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(s), int(t)) for s, t in zip(rng.integers(0, 2 ** 31, n),
                                              rng.integers(0, 200_000, n))]


@pytest.mark.parametrize("alpha", [0.2, 0.4, 1.0])
def test_mixup_lambda_is_jax_draw(alpha):
    worst = 0.0
    for seed, step in _pairs():
        for stable in (True, False):
            key = jax.random.fold_in(jax.random.key(seed), step) if stable else None
            want = float(jax_mixup_lambda(key, step, alpha))
            got = mixup_lambda(step_key(seed, step) if stable else None, step,
                               alpha)
            assert 0.5 <= got <= 1.0
            worst = max(worst, abs(got - want) / want)
    assert worst <= 1e-6, worst


def test_threefry_keys_and_bits_match_jax():
    """The hash, fold_in, split and the uniform draw bit for bit; the
    normal draw (through log1p) within 1e-6 relative."""
    for seed, step in _pairs(32, seed=1):
        k = jax.random.fold_in(jax.random.key(seed), step)
        ours = threefry.fold_in(threefry.key(seed), step)
        assert tuple(int(v) for v in jax.random.key_data(k)) == ours
        want = [tuple(int(v) for v in r)
                for r in jax.random.key_data(jax.random.split(k, 3))]
        assert threefry.split(ours, 3) == want
        assert threefry.uniform(ours) == np.float32(jax.random.uniform(k))
        np.testing.assert_allclose(threefry.normal(ours),
                                   np.float32(jax.random.normal(k)), rtol=1e-6)


# -- the BERT tower's cached-config lookup ---------------------------------------

# a BERT config as ``transformers.BertConfig.save_pretrained`` writes it (the
# keys AutoConfig reads), and a GPT-2 one
BERT_DIR_CONFIG = {"model_type": "bert", "architectures": ["BertModel"],
                   "vocab_size": 1000, "hidden_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 128, "max_position_embeddings": 128,
                   "type_vocab_size": 2, "hidden_act": "gelu",
                   "layer_norm_eps": 1e-12}
GPT_DIR_CONFIG = {"model_type": "gpt2", "n_embd": 64, "n_layer": 2,
                  "n_head": 4, "vocab_size": 1000}
FULL_ARCH = {"vocab_size": 500, "hidden_dim": 32, "depth": 1, "num_heads": 2,
             "intermediate_dim": 64}


@pytest.fixture(scope="module")
def config_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    for name, cfg in (("bert", BERT_DIR_CONFIG), ("gpt", GPT_DIR_CONFIG)):
        (root / name).mkdir()
        (root / name / "config.json").write_text(json.dumps(cfg))
    return {"bert": str(root / "bert"), "gpt": str(root / "gpt"),
            "missing": str(root / "missing"), "table": "bert-base-uncased"}


def _resolve(resolve, tag, arch):
    try:
        return resolve(tag, arch)
    except KeyError as e:
        return ("KeyError", str(e))


@pytest.mark.parametrize("tag,arch,blocked,want", [
    ("bert", None, False, "hf"), ("bert", {"depth": 1, "num_heads": 2}, False,
                                  "hf"),
    ("gpt", None, False, "KeyError"), ("missing", None, False, "KeyError"),
    ("table", None, False, "table"), ("table", {"depth": 3}, False, "table"),
    ("bert", None, True, "KeyError"), ("bert", FULL_ARCH, True, "arch"),
    ("table", None, True, "table")],
    ids=["dir", "dir+arch", "not-bert", "missing", "table", "table+arch",
         "dir-no-transformers", "dir+arch-no-transformers",
         "table-no-transformers"])
def test_bert_config_lookup_is_jax(config_dirs, monkeypatch, tag, arch,
                                   blocked, want):
    if blocked:
        # an import of transformers raises ImportError
        monkeypatch.setitem(sys.modules, "transformers", None)
    path = config_dirs[tag]
    got = _resolve(port_bert.resolve_bert_config, path, arch)
    assert got == _resolve(jax_bert.resolve_bert_config, path, arch)
    if want == "KeyError":
        assert got[0] == "KeyError"
    elif want == "hf":
        assert got["hidden_dim"] == 64 and got["vocab_size"] == 1000
        assert got["depth"] == (arch or {}).get("depth", 2)
        assert got["max_position"] == 128
    elif want == "arch":
        # transformers gone: the arch alone, as where the tag is not cached
        assert got == dict(FULL_ARCH, max_position=512, type_vocab_size=2)
    else:
        assert got == dict(port_bert.BERT_CONFIGS[path], **(arch or {}))


def test_bert_dir_tag_builds_jax_text_tower(config_dirs):
    argv = ["model.image_encoder.tag=vit_test",
            f"model.text_encoder.tag={config_dirs['bert']}",
            "transforms.input_size=32", "model.projection.dim=16",
            "model.pool.loda.image_k=3", "model.max_length=8"]
    jax_cfg = update_cfg(task_cfg_init_fn, None, argv=argv,
                         target=new_base_cfg())
    cfg = port_config.update_cfg(port_clip_config.task_cfg_init_fn, None,
                                 argv=argv, target=port_config.new_base_cfg())
    flax_model = jax_clip.build_clip_model(jax_cfg)
    dummy = {"image": np.zeros((1, 32, 32, 3), np.float32),
             "input_ids": np.zeros((1, 8), np.int32),
             "attention_mask": np.ones((1, 8), np.int32)}
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), dummy)
    want = flax_params_to_state_dict(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))
    port = build_clip_model(cfg)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert got["text_encoder.model.model.embeddings.word_embeddings.weight"] \
        == (1000, 64)
    assert len(port.bert.encoder.layer) == 2


# -- the logger's standard output -------------------------------------------------

def test_logger_writes_to_stdout_as_it_is_at_each_line():
    from simseg_tpu.utils.logger import logger as jax_logger
    from simseg_tpu_torch.utils.logger import logger

    lines = []
    for log in (jax_logger, logger):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            log.emph("after the import", 7)
        lines.append(re.sub(r"^\[[^]]*\]", "[ts]", buf.getvalue()))
    assert lines[0] == lines[1]
    assert lines[1].startswith("[ts][EMPH][test_torch_port_repairs.py:")
    assert lines[1].endswith("] after the import 7\n")
