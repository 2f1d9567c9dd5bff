"""PyTorch port (simseg_tpu_torch): BSGS (``engine/bsgs.py``) against the
JAX package's ``make_bsgs_grad_fn`` and against the port's own direct
autodiff of the whole-batch loss, on ``tests/test_models.py:tiny_clip``
with the weights carried across by the port's converter and inputs made
with numpy from a seed.

Bars: gradients at ``rtol=1e-3, atol=1e-5`` (JAX's own bar in
``tests/test_bsgs.py``), the logged loss within 1e-5 relative of the direct
loss. With dropout the frameworks' masks differ, so that case holds BSGS
against the port's direct autodiff over the same per-micro-batch keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.engine.bsgs import make_bsgs_grad_fn as jax_make_bsgs_grad_fn
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.engine import bsgs
from simseg_tpu_torch.engine.train_step import mixup_lambda, step_key
from simseg_tpu_torch.models.clip import CLIPModel, build_clip_model
from simseg_tpu_torch.ops.losses import mixup_nce, symmetric_info_nce
from simseg_tpu_torch.utils import threefry
from tests.test_torch_port_train import TINY, _pair, _trees

torch.set_num_threads(2)

SEQ = 8
SEED, STEP = 3, 5          # the step key of the mixup cases


def _batch(n, seed, ignore=None):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, SEQ), np.int64)
    mask[1, 5:] = 0
    mask[n - 1, 3:] = 0
    out = {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
           "input_ids": rng.integers(0, 128, (n, SEQ)),
           "attention_mask": mask}
    if ignore is not None:
        out["ignore_mask"] = np.zeros(n, np.float32)
        out["ignore_mask"][list(ignore)] = 1.0
    return out


# name -> (batch size, micro-batches, bsgs options, tiny_clip options,
#          ignored rows)
CASES = {
    "micro2": (16, 2, {}, {}, None),
    "micro4": (16, 4, {}, {}, None),
    "temperature": (8, 2, {}, {"temperature_init": 0.07}, None),
    "smoothing": (8, 2, {"smoothing": 0.1}, {}, None),
    "ignore_mask": (8, 2, {}, {}, (1, 4)),
    "group4": (8, 2, {"group_size": 4}, {}, None),
    "mixup_micro2": (8, 2, {"mixup": True}, {}, None),
    "mixup_micro4": (16, 4, {"mixup": True}, {}, None),
    "mixup_group": (8, 2, {"mixup": True, "group_size": 4}, {}, None),
    "tome": (16, 4, {}, {"image_arch": (("tome_r", 2),)}, None),
}


def _direct_grads(port, batch, num_micro, opts, keys=None):
    """(loss, {name: grad}) of the port's direct autodiff of the whole
    batch: the micro-batches' embeddings (each with its dropout key and,
    under mixup, its own flip) joined, one loss, one backward."""
    port.zero_grad(set_to_none=True)
    lam = (mixup_lambda(step_key(SEED, STEP), STEP, 0.2)
           if opts.get("mixup") else None)
    keys = keys or [None] * num_micro
    outs = [bsgs.embed_micro(port, mb, k, lam)
            for mb, k in zip(bsgs.split_micro(batch, num_micro), keys)]
    img, txt = (torch.cat([o[i] for o in outs]) for i in (0, 1))
    temp = outs[0][2]
    ignore = batch.get("ignore_mask")
    group = opts.get("group_size", -1)
    kw = dict(ignore_mask=ignore, smoothing=opts.get("smoothing", 0.0),
              group_size=group)
    if lam is None:
        loss, _ = symmetric_info_nce(img, txt, temp, **kw)
    else:
        fb = img.shape[0] // num_micro
        loss = 0.5 * (mixup_nce(img, txt, temp, lam, fb, **kw)[0]
                      + mixup_nce(txt, img, temp, lam, fb, **kw)[0])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return loss.item(), grads


def _assert_grads(got, want, names):
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_bsgs_grads_match_jax_and_direct(case):
    n, num_micro, opts, over, ignore = CASES[case]
    flax_model, params, port = _pair(**over)
    batch = _batch(n, 7, ignore)
    key = step_key(SEED, STEP) if opts.get("mixup") else None

    jrng = (jax.random.fold_in(jax.random.key(SEED), STEP)
            if opts.get("mixup") else None)
    jgrads, jm = jax.jit(jax_make_bsgs_grad_fn(flax_model, num_micro, **opts))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jrng, STEP)
    want = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree.map(np.asarray, jgrads)).items()}

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = bsgs.make_bsgs_grad_fn(port, num_micro, **opts)(tbatch, key, STEP)
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(want)
    _assert_grads(got, want, want)
    for k in ("loss", "temperature", "i2t_acc", "t2i_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)

    loss, direct = _direct_grads(port, tbatch, num_micro, opts)
    _assert_grads(got, {k: v.numpy() for k, v in direct.items()}, direct)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
    if case == "temperature":
        g = got["loss.temperature"]
        assert abs(g) > 1e-3
        np.testing.assert_allclose(g, want["loss.temperature"], rtol=1e-4)


def test_bsgs_dropout_replays_its_masks():
    """Dropout 0.3 in both towers and the complex projection: BSGS equals
    the direct autodiff over the same per-micro-batch keys, two calls with
    one key are bit-equal, and another key gives other gradients."""
    torch.manual_seed(0)
    port = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                     projection_name="complex", projection_dim=16,
                     image_k=3, dropout=0.3, projection_dropout=0.3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 9).items()}
    grad_fn = bsgs.make_bsgs_grad_fn(port, 2)
    key = step_key(SEED, STEP)

    def run(k):
        grad_fn(batch, k)
        return {n: p.grad.clone() for n, p in port.named_parameters()}

    first, second, other = run(key), run(key), run(step_key(SEED, STEP + 1))
    _, direct = _direct_grads(port, batch, 2, {},
                              keys=[threefry.fold_in(key, i) for i in range(2)])
    _assert_grads({k: v.numpy() for k, v in first.items()},
                  {k: v.numpy() for k, v in direct.items()}, direct)
    assert all(torch.equal(first[k], second[k]) for k in first)
    assert not torch.allclose(first["image_encoder.model.model.pos_embed"],
                              other["image_encoder.model.model.pos_embed"])
    # the masks are drawn: without a key the gradients differ from both
    grad_fn(batch)
    plain = {n: p.grad for n, p in port.named_parameters()}
    assert not torch.allclose(first["image_encoder.model.model.pos_embed"],
                              plain["image_encoder.model.model.pos_embed"])


def test_bsgs_refuses_what_jax_refuses():
    """JAX's input checks (``simseg_tpu/engine/bsgs.py:49-59, :105-114``)."""
    _, _, port = _pair()
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 1).items()}
    with pytest.raises(ValueError, match="not divisible by num_micro 3"):
        bsgs.make_bsgs_grad_fn(port, 3)(batch)
    with pytest.raises(ValueError, match="must divide batch"):
        bsgs.make_bsgs_grad_fn(port, 2, group_size=3)(batch)
    with pytest.raises(ValueError, match="nest inside"):
        bsgs.make_bsgs_grad_fn(port, 2, group_size=2, mixup=True)(batch)


# the runner's refusals (JAX: tests/test_loss_dispatch.py:132, :254; the
# MoE / PP branch of simseg_tpu/core/runner.py:370-380)
REFUSALS = {
    "loss.name=Triplet": "Triplet",
    "loss.extra_losses=['MSE']": "extra_losses",
    "dist.pp_size=2": "pp_size",
    "dist.moe_ep=True": "MoE",
}


@pytest.mark.parametrize("override", list(REFUSALS))
def test_bsgs_runner_refuses_what_jax_refuses(override):
    cfg, _ = _trees(TINY + ["runner.name=clip_bsgs", "data.batch_size=8",
                            "data.batch_size_train=4", override])
    with pytest.raises(NotImplementedError, match=REFUSALS[override]):
        CLIPRunner(cfg, build_clip_model(cfg), {"train": []}, device="cpu")
