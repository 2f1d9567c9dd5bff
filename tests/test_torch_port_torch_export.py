"""PyTorch port (simseg_tpu_torch): the reference-layout ``.pth`` writer
(``checkpoint/torch_export.py``) against JAX's ``save_clip_checkpoint``
(``simseg_tpu/checkpoint/torch_export.py:339-366``), and the export CLI
(``tools/export_torch_checkpoint.py``) against the checkpoints it reads.

From the same weights (JAX's, carried across by the port's converter; a
ViT and a ResNet image tower with BERT), the port's file and JAX's hold the
same keys and bit-equal tensors of the same shapes and dtypes, the 0-d
temperature included; JAX's ``load_clip_checkpoint`` and the port's read
the port's file back bit-identically. The CLI writes the file of a model
from the port's msgpack directory, from an orbax-backend directory and
from a ``.pth`` (a round trip), each bit-equal to the model saved.
"""

import jax
import numpy as np
import pytest
import torch

from simseg_tpu.checkpoint.torch_bridge import load_clip_checkpoint as jax_load
from simseg_tpu.checkpoint.torch_export import save_clip_checkpoint as jax_save
from simseg_tpu_torch.checkpoint.native import (make_orbax_manager,
                                                save_checkpoint,
                                                save_checkpoint_orbax)
from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
from simseg_tpu_torch.checkpoint.torch_export import save_clip_checkpoint
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.models.clip import CLIPModel, build_clip_model
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn, update_clip_config
from simseg_tpu_torch.tools import export_torch_checkpoint
from tests.test_torch_port_cnn_clip import _pair as _cnn_pair
from tests.test_torch_port_train import _FIELDS
from tests.test_torch_port_train import _pair as _vit_pair
from tests.test_train_cli import CLIP_YAML

torch.set_num_threads(2)

PAIRS = {"vit": _vit_pair, "resnet": _cnn_pair}


@pytest.mark.parametrize("tower", list(PAIRS))
def test_the_file_equals_jaxs(tower, tmp_path):
    flax_model, variables, port = PAIRS[tower]()
    ours, theirs = tmp_path / "port.pth", tmp_path / "jax.pth"
    report = save_clip_checkpoint(str(ours), port, meta={"by": "port"})
    jax_save(str(theirs), variables, projection="simple")
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    assert got["meta"] == {"by": "port"}
    assert got["state_dict"].keys() == want["state_dict"].keys()
    assert report["exported"] == sorted(want["state_dict"])
    assert report["skipped"] == []
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.is_contiguous() and g.device.type == "cpu", k
        assert torch.equal(g, v), k
    assert got["state_dict"]["loss.temperature"].dim() == 0

    # both loaders read the port's file back bit-identically
    template = jax.tree.map(np.zeros_like, variables)
    loaded, jreport = jax_load(str(ours), template, projection="simple",
                               strict=True)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                            jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    fresh = type(port)(**_fields(flax_model))
    load_clip_checkpoint(str(ours), fresh, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def _fields(flax_model):
    return {f: getattr(flax_model, f) for f in _FIELDS}


def test_strict_refuses_the_moe_leaves(tmp_path):
    """Leaves the reference layout has no slot for: ``strict`` raises
    JAX's ``ValueError``; ``strict=False`` leaves them out and says so."""
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16,
                     image_arch=(("moe_every", 2), ("moe_experts", 2)))
    with pytest.raises(ValueError, match="no slot in the reference layout"):
        save_clip_checkpoint(str(tmp_path / "a.pth"), port)
    report = save_clip_checkpoint(str(tmp_path / "b.pth"), port, strict=False)
    assert report["skipped"] and all("moe" in p for p in report["skipped"])
    got = torch.load(tmp_path / "b.pth", weights_only=True)["state_dict"]
    assert not any(".moe." in k for k in got)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A config, a model built from it with seeded weights, and the model
    saved in the three forms the CLI reads."""
    root = tmp_path_factory.mktemp("export_cli")
    (root / "clip.yaml").write_text(CLIP_YAML)
    cfg = update_cfg(task_cfg_init_fn, str(root / "clip.yaml"), [],
                     preprocess_fn=update_clip_config, target=new_base_cfg())
    torch.manual_seed(5)
    model = build_clip_model(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    save_checkpoint(str(root / "msgpack"), "ckpt", model, meta={"step": 3})
    mgr = make_orbax_manager(str(root / "orbax"))
    save_checkpoint_orbax(mgr, 3, model, None, {"step": 3})
    mgr.wait_until_finished()
    save_clip_checkpoint(str(root / "model.pth"), model)
    return root, model


@pytest.mark.parametrize("source", ["msgpack", "orbax", "model.pth"])
def test_cli_writes_the_checkpoint_it_reads(cli_setup, source, capsys):
    root, model = cli_setup
    out = root / f"from_{source}.pth"
    report = export_torch_checkpoint.main([
        "--cfg", str(root / "clip.yaml"), "--ckpt_path", str(root / source),
        "--out", str(out), "--device", "cpu"])
    assert f"wrote {out}: {len(report['exported'])} tensors" in capsys.readouterr().out
    got = torch.load(out, weights_only=True)
    assert got["meta"]["exporter"] == "simseg_tpu_torch"
    state = model.state_dict()
    assert got["state_dict"].keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(got["state_dict"][k], v), k
