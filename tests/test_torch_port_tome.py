"""PyTorch port (simseg_tpu_torch): token merging (``ops/tome.py``) and the
ViT's ``tome_r`` / ``tome_schedule`` path, held against the JAX package on
the same numpy inputs and the same weights.

Bars: the merge maps (old2new, the composed gather maps) and the merged
sizes are exact (integers, and sums of sizes taken by one-hot products);
merged tokens within 1e-6 (a size-weighted mean of a few float32 terms,
summed in another order); towers in float32 within 1e-4, the bar of
``tests/test_torch_port_models.py`` (summation order through a few
blocks), which also needs every merge decision to be the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.models.vit import build_vit as jax_build_vit
from simseg_tpu.ops import tome as jax_tome
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.models.vit import build_vit
from simseg_tpu_torch.ops import tome
from tests.test_models import tiny_clip
from tests.test_seg_decode import _norm

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(seed, t, b=3, d=16, m=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    metric = rng.normal(size=(b, t, m)).astype(np.float32)
    sizes = rng.uniform(1.0, 3.0, size=(b, t)).astype(np.float32)
    return x, sizes, metric


# ------------------------------------------------------------- the merge

@pytest.mark.parametrize("r", [0, 1, 4, 16, "clamped"])
@pytest.mark.parametrize("t", [9, 17, 325])
def test_bipartite_merge_matches_jax(t, r):
    if r == "clamped":
        r = (t + 1) // 2 + 3          # above na - 1: merge_counts clamps it
    x, sizes, metric = _tokens(t, t)
    jx, js, jmap = jax_tome.bipartite_merge(
        jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(metric), r)
    px, ps, pmap = tome.bipartite_merge(
        torch.from_numpy(x), torch.from_numpy(sizes), torch.from_numpy(metric), r)
    assert tome.merge_counts(t, r) == jax_tome.merge_counts(t, r)
    if jmap is None:
        assert pmap is None and tome.merge_counts(t, r) == 0
        assert torch.equal(px, torch.from_numpy(x))
        return
    assert px.shape == jx.shape == (3, t - tome.merge_counts(t, r), 16)
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(jmap))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-6, rtol=1e-6)


def test_merge_ties_take_the_lowest_index():
    """Equal metrics everywhere: every score ties, so argmax and top_k both
    take the lowest index, in JAX and in the port."""
    x, sizes, _ = _tokens(1, 13)
    metric = np.ones((3, 13, 4), np.float32)
    jx, js, jmap = jax_tome.bipartite_merge(
        jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(metric), 3)
    px, ps, pmap = tome.bipartite_merge(
        torch.from_numpy(x), torch.from_numpy(sizes), torch.from_numpy(metric), 3)
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(jmap))
    # A tokens 1-3 (old 2, 4, 6) merge into B token 0 (old 1)
    np.testing.assert_array_equal(pmap.numpy()[0, :8], [0, 1, 1, 2, 1, 3, 1, 4])
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-6, rtol=1e-6)


def test_gather_map_composition_and_unmerge_match_jax():
    x, sizes, metric = _tokens(2, 13)
    b, t, _ = x.shape
    jmap = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    x1, s1, m1 = jax_tome.bipartite_merge(jnp.asarray(x), jnp.asarray(sizes),
                                          jnp.asarray(metric), 3)
    jmap = jax_tome.update_gather_map(jmap, m1)
    x2, _, m2 = jax_tome.bipartite_merge(x1, s1, x1, 2)
    jmap = jax_tome.update_gather_map(jmap, m2)

    pmap = torch.arange(t).expand(b, t)
    p1, ps1, pm1 = tome.bipartite_merge(torch.from_numpy(x),
                                        torch.from_numpy(sizes),
                                        torch.from_numpy(metric), 3)
    pmap = tome.update_gather_map(pmap, pm1)
    p2, _, pm2 = tome.bipartite_merge(p1, ps1, p1, 2)
    pmap = tome.update_gather_map(pmap, pm2)
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(jmap))
    assert tome.update_gather_map(pmap, None) is pmap
    # unmerge of the same rows: the same gather, bit for bit
    out = tome.unmerge(p2, pmap)
    want = jax_tome.unmerge(jnp.asarray(p2.numpy()), jmap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_allclose(p2.numpy(), np.asarray(x2), atol=1e-6, rtol=1e-6)


def test_size_bias_matches_jax():
    sizes = np.random.default_rng(3).uniform(1.0, 9.0, (2, 7)).astype(np.float32)
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_tome.size_bias(jnp.asarray(sizes), jdt), np.float32)
        got = tome.size_bias(torch.from_numpy(sizes), pdt)
        assert got.shape == (2, 1, 1, 7) and got.dtype == pdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=0)


# --------------------------------------------------------------- towers

def _vit_pair(tag, img_size, arch, seed=0):
    flax_vit = jax_build_vit(tag, img_size, arch=arch)
    params = jax.tree.map(np.asarray, jax.jit(flax_vit.init)(
        jax.random.key(seed), jnp.zeros((1, img_size, img_size, 3))))
    prefix = "image_encoder.model.model."
    state = {k[len(prefix):]: v for k, v in flax_params_to_state_dict(
        {"params": {"image_encoder": params["params"]}}).items()}
    port = build_vit(tag, img_size, arch)
    port.load_state_dict(state, strict=True)
    return flax_vit, params, port.eval()


VITS = {
    # name -> (tag, image size, arch); T = 1 + (size / patch)^2
    "test_r2": ("vit_test", 32, dict(tome_r=2)),                    # T = 17
    "test_sched_4_0": ("vit_test", 32, dict(tome_schedule=(4, 0))),
    "test_depth4_r3": ("vit_test", 64, dict(depth=4, tome_r=3)),    # T = 65
    "test_depth4_sched": ("vit_test", 64,
                          dict(depth=4, tome_schedule=(8, 0, 0, 8))),
    "vit_s_depth3_r4": ("vit_small_patch16_224", 96,
                        dict(depth=3, tome_r=4)),                   # T = 37
    "vit_s_depth2_sched": ("vit_small_patch16_224", 96,
                           dict(depth=2, tome_schedule=(0, 6))),
}


@pytest.mark.parametrize("name", list(VITS))
def test_vit_tome_matches_flax(name):
    tag, size, arch = VITS[name]
    flax_vit, params, port = _vit_pair(tag, size, arch)
    images = np.random.default_rng(7).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(flax_vit.apply)(params, jnp.asarray(images)))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 1 + (size // port.patch_size) ** 2,
                                       port.embed_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # merged groups share a row: as many distinct rows as tokens remain
    kept = got.shape[1]
    for r in port.tome_plan:
        kept -= tome.merge_counts(kept, r)
    for i in range(2):
        assert len(np.unique(got[i].numpy(), axis=0)) <= kept


def test_vit_tome_plan_and_routing_flags():
    """The first block carries no bias (tome_first) until a merge has
    happened; every block is in the chain."""
    port = build_vit("vit_test", 32, dict(depth=4, tome_schedule=(0, 3, 0, 2)))
    assert port.tome_plan == (0, 3, 0, 2)
    assert [b.tome_first for b in port.blocks] == [True, True, False, False]
    assert all(b.tome_chain for b in port.blocks)
    plain = build_vit("vit_test", 32)
    assert not plain.tome_on and plain.tome_plan == (0, 0)


def test_vit_tome_schedule_validation():
    with pytest.raises(ValueError, match="depth-2"):
        build_vit("vit_test", 32, dict(tome_schedule=(2, 2, 2)))
    with pytest.raises(ValueError, match=">= 0"):
        build_vit("vit_test", 32, dict(tome_schedule=(2, -1)))
    imgs = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="depth-2"):
        jax_build_vit("vit_test", 32, arch=dict(tome_schedule=(2, 2, 2))).init(
            jax.random.key(0), imgs)


def test_block_refuses_a_bare_tensor_in_a_chain():
    port = build_vit("vit_test", 32, dict(tome_r=2))
    with pytest.raises(TypeError, match="carry tuple"):
        port.blocks[0](torch.zeros(1, 17, 32))


def test_tome_adds_no_parameter():
    base = build_vit("vit_test", 32).state_dict()
    for arch in (dict(tome_r=2), dict(tome_schedule=(4, 0))):
        merged = build_vit("vit_test", 32, arch).state_dict()
        assert list(merged) == list(base)
        assert all(merged[k].shape == base[k].shape for k in base)


# ----------------------------------------------------------------- CLIP

SEQ = 12


def _clip_pair(**over):
    flax_model = tiny_clip(**over)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, SEQ), jnp.int32),
             "attention_mask": jnp.ones((1, SEQ), jnp.int32)}
    params = jax.tree.map(np.asarray, jax.jit(flax_model.init)(
        jax.random.key(0), dummy))
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3, **over)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port.eval()


@pytest.mark.parametrize("arch", [(("tome_r", 2),), (("tome_schedule", (4, 0)),)])
def test_clip_model_tome_via_arch_matches_flax(arch):
    flax_model, params, port = _clip_pair(image_arch=arch)
    assert port.vit.tome_on
    rng = np.random.default_rng(4)
    batch = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 100, (2, SEQ)).astype(np.int32),
             "attention_mask": np.ones((2, SEQ), np.int32)}
    want = jax.jit(flax_model.apply)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_build_clip_model_turns_yaml_lists_into_tuples():
    from simseg_tpu_torch.config import new_base_cfg as port_base_cfg
    from simseg_tpu_torch.config import update_cfg as port_update_cfg
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn as port_init

    cfg = port_update_cfg(port_init, None, [
        "dist.bf16=false", "transforms.input_size=32",
        "model.image_encoder.tag=vit_test", "model.text_encoder.tag=bert_test",
        "model.image_encoder.arch={'tome_schedule': [4, 0], 'quant': 'int8'}",
    ], target=port_base_cfg())
    model = build_clip_model(cfg)
    assert model.vit.tome_schedule == (4, 0) and model.vit.quant == "int8"


# --------------------------------------------------- multi-scale forward

CLASSES = ["background", "dog", "cat", "bird", "tree", "car"]


def test_multi_scale_with_token_merging_matches_jax():
    """The counterpart of ``tests/test_multiscale.py``'s token-merging case:
    each scale's tower unmerges before the decode; the decode's features
    agree within 1e-4 and the histograms exactly."""
    flax_model, params, port = _clip_pair(image_arch=(("tome_r", 2),))
    cfg = update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4", "seg_eval.scales=[1.0,0.75,1.25]"],
        target=new_base_cfg())
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    tb = _norm(rng.normal(size=(len(CLASSES), 16))).astype(np.float32)
    labels = np.full((2, 64, 64), 255, np.int32)
    labels[:, :40, :48] = rng.integers(0, len(CLASSES), (2, 40, 48))
    gt_h, gt_w = np.array([40, 33]), np.array([48, 29])
    ji, ju, jpred = jax_seg_eval.make_seg_forward(
        flax_model, cfg, num_classes=6, top_cls_num=4, canvas=64, patch_size=8,
        return_pred=True)(params, jnp.asarray(images), jnp.asarray(tb),
                          jnp.asarray(labels), jnp.asarray(gt_h),
                          jnp.asarray(gt_w))
    i, u, pred = port_seg_eval.make_seg_forward(
        port, num_classes=6, top_cls_num=4, canvas=64, input_size=32,
        bilateral_stride=4, patch_size=8, return_pred=True, device="cpu",
        scales=(1.0, 0.75, 1.25))(*(torch.from_numpy(a) for a in
                                    (images, tb, labels, gt_h, gt_w)))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))



# ------------------------------------------------------------- training

GRAD_VITS = {
    # the towers of the JAX package's own ToMe training tests
    # (tests/test_tome.py:158, :262-279) and a deeper one
    "r2": ("vit_test", 32, dict(tome_r=2)),
    "sched_4_0": ("vit_test", 32, dict(tome_schedule=(4, 0))),
    "depth4_r3": ("vit_test", 64, dict(depth=4, tome_r=3)),
}


@pytest.mark.parametrize("name", list(GRAD_VITS))
def test_vit_tome_gradients_match_flax(name):
    """The guard before training with ToMe: every parameter gradient of a
    ToMe tower against ``jax.grad`` on the same weights, for the loss
    sum(tokens * G) with a seeded G (JAX's own tests take mean(tokens²),
    whose gradient the final LayerNorm leaves at float32 noise), within
    1e-4 of each gradient's largest entry (the towers' float32 bar)."""
    tag, size, arch = GRAD_VITS[name]
    flax_vit, params, port = _vit_pair(tag, size, arch)
    rng = np.random.default_rng(2)
    images = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 1 + (size // 8) ** 2, 32)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        flax_vit.apply(p, jnp.asarray(images)) * cot)))(params)
    prefix = "image_encoder.model.model."
    want = {k[len(prefix):]: v.numpy() for k, v in flax_params_to_state_dict(
        {"params": {"image_encoder": jax.tree.map(np.asarray,
                                                  want["params"])}}).items()}
    port.train()
    torch.sum(port(torch.from_numpy(images)) * torch.from_numpy(cot)).backward()
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for key in got:
        scale = float(np.abs(want[key]).max())
        assert scale > 1e-3, key
        np.testing.assert_allclose(got[key] / scale, want[key] / scale,
                                   rtol=0, atol=1e-4, err_msg=key)
