"""PyTorch port (simseg_tpu_torch): rematerialised towers (``model.remat``,
``model.remat_policy``; ``models/layers.py:remat_call``) on
``tests/test_models.py:tiny_clip``, the weights carried across by the
port's converter, inputs made with numpy from a seed.

Bars: each gradient within 1e-5 of its largest entry, against the
un-rematerialised port and against JAX's ``remat=True`` tower under
``jax.grad`` (float32 on the CPU both). Against JAX the key projections'
biases, whose gradient is zero in exact arithmetic (a softmax does not
move when all of a query's scores shift), are held to 1e-5 of the largest
entry of the model's gradients instead. The 'dots' policy recomputes no
weight product: the backward runs as many ``mm`` / ``addmm`` as without
remat, counted by a dispatch mode; 'none' runs more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from simseg_tpu.engine.train_step import clip_loss_fn as jax_clip_loss_fn
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.engine.train_step import clip_loss_fn
from simseg_tpu_torch.models.clip import CLIPModel, build_clip_model
from tests.test_torch_port_bsgs import _batch
from tests.test_torch_port_train import _FIELDS, TINY, _key_bias, _pair, _trees

torch.set_num_threads(2)

# name -> (remat policy, tiny_clip options)
CASES = {"none": ("none", {}), "dots": ("dots", {}),
         "none_tome": ("none", {"image_arch": (("tome_r", 2),)})}


def _remat_copy(flax_model, params, policy, **kw):
    """The port model of ``flax_model`` with ``params``, under remat."""
    port = CLIPModel(**{f: getattr(flax_model, f) for f in _FIELDS},
                     remat=True, remat_policy=policy, **kw)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return port


def _grads(model, batch, **kw):
    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(model, batch, **kw)
    loss.backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), out


def _assert_close(got, want, bar=1e-5, key_bias=False):
    """Each gradient within ``bar`` of its largest entry; with ``key_bias``
    the key biases within ``bar`` of the largest entry of all."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = np.asarray(got[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        keys = _key_bias(name, w.size) if key_bias else None
        if keys is not None:
            assert float(np.abs(g[keys] - w[keys]).max()) <= bar * top, name
            g, w = np.delete(g, keys), np.delete(w, keys)
            if not w.size:
                continue
        assert float(np.abs(g - w).max()) <= bar * scale, name


@pytest.mark.parametrize("case", list(CASES))
def test_remat_grads_match_plain_and_jax(case):
    policy, over = CASES[case]
    flax_model, params, plain = _pair(**over)
    remat = _remat_copy(flax_model, params, policy)
    batch = _batch(8, 4)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, want = _grads(plain, tbatch)
    loss_r, got = _grads(remat, tbatch)
    assert loss_r == loss
    _assert_close(got, {k: v.numpy() for k, v in want.items()})

    jax_remat = flax_model.clone(remat=True, remat_policy=policy)
    jgrads = jax.jit(jax.grad(lambda p: jax_clip_loss_fn(
        jax_remat, p, {k: jnp.asarray(v) for k, v in batch.items()},
        None)[0]))(params)
    jwant = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree.map(np.asarray, jgrads)).items()}
    _assert_close({k: v.numpy() for k, v in got.items()}, jwant,
                  key_bias=True)


class _CountProducts(TorchDispatchMode):
    """Counts ``mm`` and ``addmm`` calls."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _backward_products(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(model, batch)
    with _CountProducts() as mode:
        loss.backward()
    model.zero_grad(set_to_none=True)
    return mode.count


def test_dots_policy_recomputes_no_weight_product():
    flax_model, params, plain = _pair()
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 5).items()}
    counts = {policy: _backward_products(
        _remat_copy(flax_model, params, policy), batch)
        for policy in ("none", "dots")}
    base = _backward_products(plain, batch)
    assert base > 0
    assert counts["dots"] == base
    # the recompute of 'none' runs the blocks' linears again, two blocks of
    # each tower: a BERT layer's 6, a ViT block's first 3 (the recompute
    # stops at the last tensor the backward needs, and nothing saves fc2's
    # output: the residual add keeps no input)
    assert counts["none"] == base + 2 * 3 + 2 * 6


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_replays_the_dropout_masks(policy):
    """Dropout 0.2 in both towers: the recompute draws the masks of the
    first forward, so remat changes no gradient; another key does."""
    torch.manual_seed(0)
    kw = dict(image_tag="vit_test", img_size=32, text_tag="bert_test",
              projection_dim=16, image_k=3, dropout=0.2)
    plain = CLIPModel(**kw)
    remat = CLIPModel(remat=True, remat_policy=policy, **kw)
    remat.load_state_dict(plain.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 6).items()}
    step = dict(deterministic=False, seed=11, step=3)
    loss, want = _grads(plain, batch, **step)
    loss_r, got = _grads(remat, batch, **step)
    assert loss_r == loss
    _assert_close({k: v.numpy() for k, v in got.items()},
                  {k: v.numpy() for k, v in want.items()})
    _, other = _grads(remat, batch, deterministic=False, seed=11, step=4)
    assert not torch.allclose(other["image_encoder.model.model.pos_embed"],
                              got["image_encoder.model.model.pos_embed"])


def test_build_clip_model_reads_remat():
    cfg, _ = _trees(TINY + ["model.remat=True", "model.remat_policy=dots"])
    model = build_clip_model(cfg)
    for tower in (model.vit, model.bert):
        assert tower.remat and tower.remat_policy == "dots"
    cfg, _ = _trees(TINY + ["model.remat=True", "model.remat_policy=full"])
    with pytest.raises(NotImplementedError, match="remat_policy 'full'"):
        build_clip_model(cfg)


@pytest.mark.parametrize("lane", ["flash_mha", "flash_mha_train",
                                  "flash_mha_rowblock", "flash_mha_stream"])
def test_attention_lanes_under_remat(lane):
    """Each attention lane's autograd function (their CPU versions) inside a
    non-reentrant checkpoint: the backward reads its saved tensors once
    (a second read raises there) and gives the gradients of the same call
    without remat."""
    from simseg_tpu_torch.models.layers import remat_call
    from simseg_tpu_torch.ops import flash_attention

    fn = getattr(flash_attention, lane)
    rng = np.random.default_rng(2)
    qkv = [torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
           for _ in range(3)]
    g = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))

    def grads(run):
        leaves = [x.clone().requires_grad_() for x in qkv]
        return torch.autograd.grad(run(*leaves), leaves, g)

    want = grads(fn)
    for policy in ("none", "dots"):
        got = grads(lambda *a: remat_call(fn, policy, *a))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
