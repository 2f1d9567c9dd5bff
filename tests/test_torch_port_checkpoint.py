"""PyTorch port (simseg_tpu_torch): loading reference ``.pth`` checkpoints,
held against the JAX package's loader on the same file.

Each file is written by ``simseg_tpu.checkpoint.torch_export`` from a tiny
model at one grid (16 px, 2x2 patches) and loaded into a model at another
(32 px, 4x4), so the position embeddings are resampled on both sides. The
JAX loader reports missing entries as flax paths and the port as state-dict
names, so those are compared by count. Bars: matched and unexpected names
equal, mismatched and missing counts equal, loaded weights within 1e-6
(the same float32 resampling matrices, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.checkpoint.torch_bridge import load_clip_checkpoint as jax_load
from simseg_tpu.checkpoint.torch_export import save_clip_checkpoint
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.checkpoint.torch_bridge import (
    convert_keys,
    load_clip_checkpoint,
    load_torch_state_dict,
)
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed
from tests.test_models import tiny_clip

torch.set_num_threads(1)

_POS = "image_encoder.model.model.pos_embed"


def _params(img_size, seed):
    dummy = {"image": jnp.zeros((1, img_size, img_size, 3)),
             "input_ids": jnp.zeros((1, 12), jnp.int32),
             "attention_mask": jnp.ones((1, 12), jnp.int32)}
    return jax.tree.map(np.asarray, tiny_clip(img_size=img_size).init(
        jax.random.key(seed), dummy))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path: the exported file, and variants of it."""
    root = tmp_path_factory.mktemp("ckpt")
    plain = str(root / "plain.pth")
    save_clip_checkpoint(plain, _params(16, 1))
    payload = torch.load(plain, weights_only=True)
    state = payload["state_dict"]
    out = {"plain": plain}
    # a DataParallel-style file under the legacy container key, with an
    # entry the model has no slot for and one of the wrong shape
    extras = {f"module.{k}": v for k, v in state.items()}
    extras["module.extra.weight"] = torch.ones(3)
    extras["module.image_projection.linear.weight"] = torch.ones(4, 4)
    out["module_extras"] = str(root / "module_extras.pth")
    torch.save({"model_state_dict": extras}, out["module_extras"])
    out["bare"] = str(root / "bare.pth")
    torch.save(state, out["bare"])
    return out


def _port_model(params):
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return port


@pytest.mark.parametrize("name,kw", [
    ("plain", {}), ("bare", {}), ("module_extras", {}),
    ("plain", {"only_image_encoder": True}),
    ("module_extras", {"only_text_encoder": True}),
    ("plain", {"prefix_rules": ["text_projection.->text_head."]}),
])
def test_loader_matches_jax(files, name, kw):
    target = _params(32, 2)
    jparams, jrep = jax_load(files[name], target, **kw)
    port = _port_model(target)
    rep = load_clip_checkpoint(files[name], port, **kw)

    assert sorted(rep["matched"]) == sorted(jrep["matched"])
    assert sorted(rep["unexpected"]) == sorted(jrep["unexpected"])
    assert len(rep["mismatched"]) == len(jrep["mismatched"])
    assert len(rep["missing"]) == len(jrep["missing"])
    assert [m[0] for m in rep["mismatched"]] == [m[0] for m in jrep["mismatched"]]
    assert (_POS in rep["matched"]) == (not kw.get("only_text_encoder"))
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jparams))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_pos_embed_is_the_resampled_one(files):
    port = _port_model(_params(32, 2))
    rep = load_clip_checkpoint(files["plain"], port, strict=True)
    assert not rep["missing"] and not rep["mismatched"]
    saved = load_torch_state_dict(files["plain"])[_POS]
    assert saved.shape == (1, 5, 32)
    torch.testing.assert_close(port.state_dict()[_POS],
                               interpolate_pos_embed(saved, 16), rtol=0, atol=0)


def test_strict_load_refuses_missing_and_mismatched(files):
    port = _port_model(_params(32, 2))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="strict load failed"):
        load_clip_checkpoint(files["module_extras"], port, strict=True)
    for key, value in port.state_dict().items():
        assert torch.equal(value, before[key]), key
    # a tower filter turns strict off, as in the reference
    rep = load_clip_checkpoint(files["plain"], port, strict=True,
                               only_image_encoder=True)
    assert rep["missing"] and all(k.startswith("text_") or k == "loss.temperature"
                                  for k in rep["missing"])


def test_convert_keys_first_rule_wins():
    state = {"a.x": 1, "ab.y": 2, "c.z": 3}
    assert convert_keys(state, ["a.->b.", "ab.->d.", "a->e"]) == {
        "b.x": 1, "d.y": 2, "c.z": 3}


def test_load_pretrained_params_chooses_by_extension(files, tmp_path):
    """A ``.pth`` through the bridge (pos_embed resampled, as
    ``load_clip_checkpoint`` gives it); anything else as the port's own
    checkpoint directory, or a ``ckpt.dir`` through its latest pointer
    (JAX ``load_pretrained_params``)."""
    from simseg_tpu_torch.checkpoint import load_pretrained_params
    from simseg_tpu_torch.checkpoint.native import save_checkpoint

    want = _port_model(_params(32, 2))
    load_clip_checkpoint(files["plain"], want)
    got = load_pretrained_params(files["plain"], _port_model(_params(32, 3)))
    for key, value in want.state_dict().items():
        assert torch.equal(got.state_dict()[key], value), key
    path = save_checkpoint(str(tmp_path), "step_checkpoint", want)
    for source in (path, str(tmp_path)):
        port = load_pretrained_params(source, _port_model(_params(32, 4)))
        for key, value in want.state_dict().items():
            assert torch.equal(port.state_dict()[key], value), (source, key)
