"""The plain reference against the program's own CPU path at test sizes,
both in float32: the towers, the embeddings and the training steps agree,
so a gap on the card is the program's precision or a fault, not a
difference of definitions."""

import os

import pytest
import torch

from conftest import HERE, read
from pbench import data, program
from pbench.weights import make_state
from pbench_ref import precise
from pbench_ref import train as ref_train
from pbench_ref.clip import Ref, param_shapes

SEED = 4242424242


class _Ctx:
    def __init__(self, img_size=32):
        self.config = read(os.path.join(HERE, "data", "configs", "tiny.json"))
        self.sizes = dict(self.config["sizes"])
        self.sizes["image"] = dict(self.sizes["image"], img_size=img_size)
        self.device = torch.device("cpu")
        self.seed = SEED


def _float32_model(ctx, overrides=()):
    cfg = program.config_tree(ctx.config, ["dist.bf16=False",
                                           f"transforms.input_size={ctx.sizes['image']['img_size']}",
                                           *overrides])
    state = make_state(param_shapes(ctx.sizes), SEED, "cpu", 0.02)
    return program.model(ctx, cfg, state).eval(), state, cfg


def test_towers_match():
    ctx = _Ctx()
    model, state, _ = _float32_model(ctx)
    ref = Ref(state, ctx.sizes)
    x = torch.randn(2, 40, 40, 3)  # another size: the position grid resampled
    ids = torch.randint(5, 100, (3, 9))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    with torch.no_grad(), precise():
        torch.testing.assert_close(ref.image_tokens(x), model.forward_image_tokens(x),
                                   rtol=1e-4, atol=1e-4)
        got = model.forward_text_project(model.forward_text_feature(ids, mask), mask)
        torch.testing.assert_close(ref.text_embed(ids, mask, 1), got, rtol=1e-4, atol=1e-5)
        patches = model.forward_image_tokens(x)[:, 1:]
        torch.testing.assert_close(ref.image_embed(patches, 5),
                                   model.forward_image_project(patches), rtol=1e-4, atol=1e-5)


def test_training_step_matches():
    from simseg_tpu_torch.core.lr_schedule import build_schedule
    from simseg_tpu_torch.core.optim import build_optimizer
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.engine.train_step import make_train_step

    ctx = _Ctx()
    model, state, cfg = _float32_model(ctx)
    model.train()
    opt = build_optimizer(cfg, model)
    sched = build_schedule(cfg, 1000)
    step = make_train_step(model, opt, seed=0)
    pool = data.train_pool(SEED, "cpu", 2, 6, 24, 25, ctx.sizes["text"]["vocab"], 6, 4)
    mean, std = tuple(cfg.transforms.normalize.mean), tuple(cfg.transforms.normalize.std)
    losses = []
    for i, b in enumerate(pool):
        batch = dict(b, image=normalize_images(b["image"], mean, std))
        losses.append(float(step(batch, sched(30 + i), 30 + i, False)["loss"]))
    y = cfg.optim
    with precise():
        params = {k: v.clone().requires_grad_(True)
                  for k, v in make_state(param_shapes(ctx.sizes), SEED, "cpu", 0.02).items()}
        ref = Ref(params, ctx.sizes)
        adamw = ref_train.AdamW(params, tuple(y.param.betas), y.param.eps, y.param.weight_decay)
        lrs = [ref_train.lr(30 + i, y.lr.init, y.lr.warmup_proportion, 1000,
                            y.lr.param.num_cycles, y.lr.param.min_lr_scale) for i in range(2)]
        assert lrs == [sched(30), sched(31)]
        got = ref_train.follow(ref, pool, lrs, adamw, mean, std, 5, 1)
    assert got["loss"] == pytest.approx(losses, rel=1e-4)
    for n, p in model.named_parameters():
        torch.testing.assert_close(params[n].detach(), p.detach(), rtol=1e-4, atol=1e-6)
