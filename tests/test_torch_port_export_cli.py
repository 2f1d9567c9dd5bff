"""PyTorch port (simseg_tpu_torch): the serving export CLI
(``python -m simseg_tpu_torch.tools.export_serving``, ``main(argv)``) on the
CPU, on a tiny YAML (``vit_test`` / ``bert_test`` at 32 px), a seeded
``.pth`` and a test vocab: both kinds, both weight layouts and an
int8_static image tower calibrated by the tool. The written artifact,
loaded, gives the live staged module's outputs bit for bit; JAX's
``--platforms`` is refused.
"""

import numpy as np
import pytest
import torch

from simseg_tpu_torch import serving
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.tokenizer import make_test_vocab
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config
from simseg_tpu_torch.tasks.seg_eval import load_label_bank
from simseg_tpu_torch.tools import export_serving
from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

torch.set_num_threads(1)

YAML = """\
model:
  max_length: 12
  image_encoder:
    tag: vit_test
  text_encoder:
    tag: bert_test
    arch: {vocab_size: 512}
  projection:
    name: simple
    dim: 16
  pool:
    name: loda
    loda:
      image_k: 3
      text_k: 1
transforms:
  input_size: 32
dist:
  bf16: False
seg_eval:
  bilateral_stride: 4
"""


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    (root / "tiny.yaml").write_text(YAML)
    words = [w for t in IMAGENET_TEMPLATES
             for w in t.replace("{}", " ").replace(".", " ").split()]
    vocab = make_test_vocab(words + load_label_bank("pascal_voc"))
    assert len(vocab) <= 512
    (root / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    cfg = update_cfg(task_cfg_init_fn, str(root / "tiny.yaml"),
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    torch.manual_seed(5)
    torch.save({"state_dict": build_clip_model(cfg).state_dict()},
               root / "tiny.pth")
    return root


def _argv(root, kind, weights, *extra):
    return ["--cfg", str(root / "tiny.yaml"), "--ckpt_path",
            str(root / "tiny.pth"), "--vocab_file", str(root / "vocab.txt"),
            "--kind", kind, "--weights", weights, "--batch", "2",
            "--out", str(root / f"{kind}-{weights}.pt2"), "--device", "cpu",
            *extra]


def _data(kind):
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8))
    if kind == "seg":
        return (images,)
    return (images, torch.from_numpy(rng.integers(0, 300, (2, 12))),
            torch.ones((2, 12), dtype=torch.long))


@pytest.mark.parametrize("kind,weights,extra", [
    ("seg", "baked", ()), ("seg", "separate", ()),
    ("retrieval", "baked", ()), ("retrieval", "separate", ()),
    ("seg", "baked", ("model.image_encoder.arch={'quant': 'int8_static'}",
                      "--calib_images", "4")),
])
def test_export_cli_artifact_gives_the_live_outputs(fixture, kind, weights,
                                                    extra):
    argv = _argv(fixture, kind, weights, *extra)
    fn = export_serving.main(argv)
    out = argv[argv.index("--out") + 1]
    data = _data(kind)
    if weights == "baked":
        live, got = fn(*data), serving.load_artifact(out)(*data)
    else:
        live = fn(fn.params, *data)
        got = serving.load_artifact_separate(out)(*data)
    for g, w in zip(got, live):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kind == "seg":
        assert got[0].shape == (2, 32, 32)
    else:
        assert got[0].shape == got[1].shape == (2, 16)


def test_export_cli_refuses_platforms(fixture):
    with pytest.raises(SystemExit, match="device it runs on"):
        export_serving.main(_argv(fixture, "seg", "baked", "--platforms",
                                  "tpu"))
