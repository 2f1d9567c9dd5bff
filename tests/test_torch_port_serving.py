"""PyTorch port (simseg_tpu_torch): serving export (``serving.py``) on the
CPU, the counterpart of ``tests/test_serving.py``.

A loaded ``torch.export`` artifact must give the live port's pipeline bit
for bit (on the CPU its graph is the same aten ops and the kernels' plain
versions), and the JAX package's serving functions on the same weights:
the seg artifact's pred on >= 99.9% of pixels (``PIXEL_BAR``, as
``tests/test_torch_port_seg.py``: a CRF pixel at the threshold may flip
under another float32 summation order), the embed artifact within 1e-5
(float32 towers, sums in another order).

Fixture: the tiny ``vit_test`` / ``bert_test`` CLIP at 32 px of
``tests/test_torch_port_seg.py``, JAX's parameters converted by
``flax_params_to_state_dict``; the variants (ToMe, int8) on seeded torch
weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu import serving as jax_serving
from simseg_tpu.utils.collections import AttrDict as JaxAttrDict
from simseg_tpu_torch import serving
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.pooling import l2_normalize
from simseg_tpu_torch.ops.quant import cache_quant_state
from simseg_tpu_torch.tasks.seg_eval import image_patch_stride, make_seg_predict
from simseg_tpu_torch.utils.collections import AttrDict
from tests.test_models import tiny_clip

torch.set_num_threads(1)

PIXEL_BAR = 0.999
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _cfg(attr_dict=AttrDict, **seg_eval):
    cfg = attr_dict()
    cfg.transforms = attr_dict()
    cfg.transforms.input_size = 32
    cfg.transforms.normalize = attr_dict(mean=MEAN, std=STD)
    if seg_eval:
        cfg.seg_eval = attr_dict(**seg_eval)
    return cfg


def _port(seed=0, **over):
    torch.manual_seed(seed)
    return CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3, **over).eval()


@pytest.fixture(scope="module")
def pair():
    """(flax model, its parameters, the port's model on them)."""
    flax_model = tiny_clip()
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0), {
        "image": jnp.zeros((1, 32, 32, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32)}))
    port = _port()
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port


def _inputs(seed, b=2, classes=5):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(classes, 16)).astype(np.float32)
    raw = rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8)
    return bank, raw


def _seg_fn(port, bank, cfg=None, **kw):
    return serving.make_seg_infer_fn(port, torch.from_numpy(bank),
                                     cfg or _cfg(), num_classes=5,
                                     top_cls_num=3, device="cpu", **kw)


def _roundtrip(tmp_path, fn, args, name="a.pt2"):
    path = str(tmp_path / name)
    serving.save_artifact(path, serving.export_artifact(fn, args))
    return serving.load_artifact(path)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _jax_seg(flax_model, params, bank, cfg, raw):
    fn = jax_serving.make_seg_infer_fn(flax_model, params, jnp.asarray(bank),
                                       cfg, num_classes=5, top_cls_num=3,
                                       patch_size=8)
    return np.asarray(jax.jit(fn)(raw)[0])


@pytest.fixture(scope="module")
def baked(pair, tmp_path_factory):
    """The default seg artifact on four images: (path, bank, images, the
    live call's outputs, the loaded artifact's)."""
    _, _, port = pair
    bank, raw = _inputs(0, b=4)
    fn = _seg_fn(port, bank)
    x = torch.from_numpy(raw)
    path = str(tmp_path_factory.mktemp("baked") / "seg.pt2")
    serving.save_artifact(path, serving.export_artifact(fn, (x,)))
    return path, bank, x, fn(x), serving.load_artifact(path)(x)


def test_seg_artifact_roundtrip(pair, baked):
    """Loaded == live, and the pred of JAX's jitted serving function on the
    same weights and bank."""
    flax_model, params, _ = pair
    _, bank, x, live, got = baked
    _assert_equal(got, live)
    assert got[0].shape == (4, 32, 32) and got[0].dtype == torch.int32
    want = _jax_seg(flax_model, params, bank, _cfg(JaxAttrDict), x.numpy())
    assert (got[0].numpy() == want).mean() >= PIXEL_BAR


def test_seg_artifact_matches_eval_pipeline(pair, baked):
    """The exported graph IS make_seg_predict: the eval tool's forward core
    on the same raw input and the L2-normed bank."""
    _, _, port = pair
    _, bank, x, _, got = baked
    predict = make_seg_predict(port, 5, 3, input_size=32, device="cpu")
    _assert_equal(got, predict(x, l2_normalize(torch.from_numpy(bank))))


def test_seg_artifact_honors_multiscale_cfg(tmp_path, pair, baked):
    """cfg.seg_eval.scales is staged into the artifact: it matches the live
    multi-scale pipeline and JAX's, and differs from single-scale."""
    flax_model, params, port = pair
    _, bank, x, single, _ = baked
    fn = _seg_fn(port, bank, _cfg(scales=[1.0, 0.5]))
    got = _roundtrip(tmp_path, fn, (x,))(x)
    _assert_equal(got, fn(x))
    jcfg = _cfg(JaxAttrDict)
    jcfg.seg_eval = JaxAttrDict(scales=[1.0, 0.5])
    want = _jax_seg(flax_model, params, bank, jcfg, x.numpy())
    assert (got[0].numpy() == want).mean() >= PIXEL_BAR
    assert not torch.equal(got[1], single[1])


@pytest.mark.parametrize("name,seg_eval", [
    ("window", dict(window=dict(size=16, stride=8))),
    ("fused_tail", dict(crf_backend="fused_tail")),
])
def test_seg_artifact_honors_decode_knobs(tmp_path, pair, name, seg_eval):
    """A sliding window and the fused decode tail, each staged: loaded ==
    live."""
    _, _, port = pair
    bank, raw = _inputs(8)
    x = torch.from_numpy(raw)
    fn = _seg_fn(port, bank, _cfg(**seg_eval))
    _assert_equal(_roundtrip(tmp_path, fn, (x,))(x), fn(x))


def test_embed_artifact_bakes_normalization(tmp_path, pair):
    """kind=retrieval with a cfg: raw uint8 in, normalisation staged;
    loaded == live, and within 1e-5 of JAX's make_embed_fn."""
    flax_model, params, port = pair
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    ids = rng.integers(0, 128, (4, 12)).astype(np.int64)
    mask = np.ones((4, 12), np.int64)
    args = tuple(torch.from_numpy(a) for a in (raw, ids, mask))
    fn = serving.make_embed_fn(port, _cfg(), device="cpu")
    got = _roundtrip(tmp_path, fn, args)(*args)
    _assert_equal(got, fn(*args))
    want = jax.jit(jax_serving.make_embed_fn(flax_model, params,
                                             _cfg(JaxAttrDict)))(
        raw, ids.astype(np.int32), mask.astype(np.int32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_embed_artifact_roundtrip(tmp_path, pair):
    """cfg=None: normalised float images in; the weights are inside, the
    artifact takes the data inputs only."""
    _, _, port = pair
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 128, (4, 12))),
            torch.ones((4, 12), dtype=torch.long))
    fn = serving.make_embed_fn(port, device="cpu")
    got = _roundtrip(tmp_path, fn, args)(*args)
    _assert_equal(got, fn(*args))
    assert got[0].shape == (4, 16) and got[1].shape == (4, 16)


def test_seg_artifact_holds_no_text_tower(pair, baked):
    """The seg artifact's state is the image side and the bank: no
    ``text_encoder.*`` or ``text_projection.*`` key, every image-side
    parameter present."""
    _, _, port = pair
    state = torch.export.load(baked[0]).state_dict
    assert not [k for k in state if "text_encoder" in k or "text_projection" in k]
    image_side = {f"model.{k}" for k in port.state_dict()
                  if k.startswith(("image_encoder.", "image_projection."))}
    assert image_side <= set(state) and "text_bank" in state


def test_separate_weights_artifact_matches_baked(tmp_path, pair, baked):
    """weights='separate': the graph with the weights as inputs and the
    ``.weights`` sidecar give the baked artifact's outputs; the graph file
    is smaller than the baked one by more than the sidecar's half."""
    _, _, port = pair
    baked_path, bank, x, _, want = baked
    fn = _seg_fn(port, bank, bake_weights=False)
    path = str(tmp_path / "sep.pt2")
    serving.export_artifact_separate(fn, fn.params, (x,), path)
    assert (tmp_path / "sep.pt2.weights").exists()
    _assert_equal(serving.load_artifact_separate(path)(x), want)
    weights = (tmp_path / "sep.pt2.weights").stat().st_size
    saved = os.path.getsize(baked_path) - (tmp_path / "sep.pt2").stat().st_size
    assert saved > weights / 2


def test_image_patch_stride_standard_tags():
    """The grid step of the seg pipeline: the ViT's patch from its tag
    (timm patterns parsed, not only the table), a ResNet's total stride."""
    from simseg_tpu_torch.models.cnn import build_cnn
    from simseg_tpu_torch.models.vit import resolve_vit_config

    assert resolve_vit_config("vit_base_patch16_224_in21k")["patch_size"] == 16
    assert resolve_vit_config("vit_large_patch32_384")["patch_size"] == 32
    assert image_patch_stride(_port()) == 8
    assert build_cnn("resnet50").patch_size == 32


def test_seg_artifact_with_token_merging(tmp_path):
    """A ToMe tower (r = 2) stages and serves like any other."""
    bank, raw = _inputs(1)
    x = torch.from_numpy(raw)
    fn = _seg_fn(_port(image_arch=(("tome_r", 2),)), bank)
    _assert_equal(_roundtrip(tmp_path, fn, (x,))(x), fn(x))


def test_seg_artifact_with_int8_quant(tmp_path):
    """int8 towers (weights quantised in the graph) serve bit-identically
    to the live pipeline."""
    bank, raw = _inputs(2)
    x = torch.from_numpy(raw)
    fn = _seg_fn(_port(image_arch=(("quant", "int8"),),
                       text_arch=(("quant", "int8"),)), bank)
    _assert_equal(_roundtrip(tmp_path, fn, (x,))(x), fn(x))


def test_seg_artifact_int8_static_composed_headline(tmp_path):
    """bench.py's default lane, ToMe r = 2 with an int8_static image tower:
    an uncalibrated tower refuses to stage; calibrated on two batches it
    serves bit-identically to the live pipeline."""
    port = _port(image_arch=(("quant", "int8_static"), ("tome_r", 2)))
    bank, raw = _inputs(3)
    x = torch.from_numpy(raw)
    with pytest.raises(RuntimeError, match="cache_quant_state"):
        serving.export_artifact(_seg_fn(port, bank), (x,))
    rng = np.random.default_rng(3)
    calib = [torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
             for _ in range(2)]
    cache_quant_state(port, [lambda im=im: port.forward_image_tokens(im)
                             for im in calib])
    fn = _seg_fn(port, bank)
    _assert_equal(_roundtrip(tmp_path, fn, (x,))(x), fn(x))


def test_seg_artifact_multichip_data_parallel(baked):
    """One artifact served over two devices: each takes half the batch, the
    results equal the one-device call's."""
    path, _, x, _, want = baked
    _assert_equal(serving.load_artifact(path, devices=["cpu", "cpu"])(x), want)


def test_separate_weights_artifact_multichip(tmp_path, pair):
    """The separate layout over two devices: the weights replicated, the
    data split; embeddings equal to the one-device call's."""
    _, _, port = pair
    rng = np.random.default_rng(3)
    args = (torch.from_numpy(rng.integers(0, 255, (4, 32, 32, 3)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 30, (4, 12))),
            torch.ones((4, 12), dtype=torch.long))
    fn = serving.make_embed_fn(port, _cfg(), bake_weights=False, device="cpu")
    path = str(tmp_path / "emb_dp.pt2")
    serving.export_artifact_separate(fn, fn.params, args, path)
    want = serving.load_artifact_separate(path)(*args)
    _assert_equal(serving.load_artifact_separate(
        path, devices=["cpu", "cpu"])(*args), want)


def test_multichip_serve_rejects_indivisible_batch(baked):
    """A batch that does not split over the devices is refused with JAX's
    message, not sent to a device short."""
    path, _, x, _, _ = baked
    served = serving.load_artifact(path, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="batch-sharded"):
        served(x)
