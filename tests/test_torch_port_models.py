"""PyTorch port (simseg_tpu_torch): CLIP towers and the weight converter,
held against the flax model on the same parameters and numpy inputs.

Both sides run float32 on the CPU (JAX at matmul precision 'highest', set
in tests/conftest.py); the towers agree to atol/rtol 1e-4, which leaves
room for summation-order differences through two transformer layers of
width up to 768 and nothing more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.checkpoint.torch_export import flax_to_torch
from simseg_tpu.models.clip import CLIPModel as JaxCLIP
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.models.vit import resolve_vit_config
from tests.test_models import tiny_clip

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 12

# name -> (flax CLIPModel kwargs, image size); the port is built from the
# same kwargs
CONFIGS = {
    "tiny": dict(),
    "vit_s_bert_test_depth2": dict(
        image_tag="vit_small_patch16_224", img_size=64,
        image_arch=(("depth", 2),), projection_dim=64, image_k=5),
    "vit_b_bert_base_depth2_complex": dict(
        image_tag="vit_base_patch16_224_in21k", img_size=64,
        image_arch=(("depth", 2),), text_tag="bert-base-uncased",
        text_arch=(("depth", 2),), projection_name="complex",
        projection_dim=128, image_k=5),
}


def _pair(name):
    flax_model = tiny_clip(**CONFIGS[name])
    size = flax_model.img_size
    dummy = {
        "image": jnp.zeros((1, size, size, 3)),
        "input_ids": jnp.zeros((1, SEQ), jnp.int32),
        "attention_mask": jnp.ones((1, SEQ), jnp.int32),
    }
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0), dummy))
    fields = ("image_tag", "img_size", "image_arch", "text_tag", "text_arch",
              "target_token_idx", "projection_name", "projection_dim",
              "pool_name", "image_k", "text_k", "temperature_name",
              "temperature_init")
    port = CLIPModel(**{f: getattr(flax_model, f) for f in fields})
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port.eval()


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in CONFIGS}


def _inputs(flax_model, seed=0):
    rng = np.random.default_rng(seed)
    size = flax_model.img_size
    images = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    vocab = 128 if flax_model.text_tag == "bert_test" else 30522
    ids = rng.integers(0, vocab, (2, SEQ)).astype(np.int32)
    mask = np.ones((2, SEQ), np.int32)
    mask[1, 7:] = 0
    return images, ids, mask


def _run(name, method, flax_model, params, port):
    images, ids, mask = _inputs(flax_model)
    t = torch.from_numpy
    with torch.no_grad():
        if method == "temperature":
            return (port.temperature(),
                    flax_model.apply(params, method=lambda m: m.temperature()))
        if method in ("forward_image_feature", "forward_image_tokens"):
            return (getattr(port, method)(t(images)),
                    flax_model.apply(params, jnp.asarray(images),
                                     method=getattr(JaxCLIP, method)))
        if method in ("forward_image_project", "project_image_tokens"):
            n = (flax_model.img_size // resolve_vit_config(
                flax_model.image_tag, dict(flax_model.image_arch or ()))
                ["patch_size"]) ** 2
            width = port.vit.embed_dim
            feats = np.random.default_rng(1).normal(
                size=(2, n, width)).astype(np.float32)
            return (getattr(port, method)(t(feats)),
                    flax_model.apply(params, jnp.asarray(feats),
                                     method=getattr(JaxCLIP, method)))
        if method == "forward_text_feature":
            return (port.forward_text_feature(t(ids).long(), t(mask)),
                    flax_model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                     method=JaxCLIP.forward_text_feature))
        assert method == "forward_text_project"
        width = port.bert.embeddings.word_embeddings.embedding_dim
        feats = np.random.default_rng(2).normal(
            size=(2, SEQ, width)).astype(np.float32)
        return (port.forward_text_project(t(feats), t(mask)),
                flax_model.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                                 method=JaxCLIP.forward_text_project))


METHODS = ["temperature", "forward_image_feature", "forward_image_tokens",
           "forward_image_project", "project_image_tokens",
           "forward_text_feature", "forward_text_project"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_clip_method_matches_flax(pairs, name, method):
    flax_model, params, port = pairs[name]
    ours, ref = _run(name, method, flax_model, params, port)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_matches_flax_to_torch(pairs, name):
    """The port's converter gives flax_to_torch's names and values."""
    _, params, _ = pairs[name]
    ours = flax_params_to_state_dict(params)
    ref, _ = flax_to_torch(params, projection=CONFIGS[name].get(
        "projection_name", "simple"))
    assert sorted(ours) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)


def test_converter_refuses_unmapped_leaves(pairs):
    _, params, _ = pairs["tiny"]
    bad = {"params": {**params["params"], "extra_head": {"kernel": np.ones(2)}}}
    with pytest.raises(ValueError, match="extra_head"):
        flax_params_to_state_dict(bad)


def test_vit_tags_resolve_to_published_widths():
    assert resolve_vit_config("vit_base_patch16_224_in21k") == dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12)
    assert resolve_vit_config("vit_small_patch16_224") == dict(
        patch_size=16, embed_dim=384, depth=12, num_heads=6)
    with pytest.raises(KeyError):
        resolve_vit_config("not_a_vit")
