"""The contrastive train step (port of ``simseg_tpu/engine/train_step.py``,
single device).

Parity: reference hot loop ``tasks/clip/clip_runner.py:216-251``
(batch_processor: forward -> loss dict -> backward -> step). One step is
forward (the towers in the model's compute dtype), the loss in float32,
backward, the host-computed lr written into the optimizer, the optimizer
step (clipping and the non-finite guard inside), and the metrics
``grad_norm`` (before clipping) and ``lr``.

On one card the global batch is the local batch, so the all-gather of
negatives is the identity. Not ported yet: the mesh, ZeRO-1, FSDP, TP, PP,
MoE and live-BN branches (ROADMAP queue 1 items 8 and 11-13).

The attention kernels' training lane needs no marker: autograd knows that
a call is differentiated (``ops/attention.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from simseg_tpu_torch.ops.losses import (mixup_nce, mse_embedding_loss,
                                         symmetric_info_nce, triplet_loss)


def mixup_lambda(seed: int, step: int, alpha: float) -> float:
    """Per-step Beta(alpha, alpha) mixup coefficient in [0.5, 1], drawn on
    the host from (seed, step). JAX draws it with ``jax.random``; the two
    give different numbers from the same seed."""
    lam = float(np.random.default_rng([seed, step]).beta(alpha, alpha))
    return max(lam, 1.0 - lam)


def clip_loss_fn(
    model,
    batch: Dict[str, torch.Tensor],
    smoothing: float = 0.0,
    loss_name: str = "NCE",
    mixup_alpha_param: float = 0.2,
    triplet_margin: float = 0.2,
    triplet_reduce: str = "max",
    extra_losses: Tuple[str, ...] = (),
    deterministic: bool = True,
    step: int = 0,
    seed: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + contrastive loss (JAX ``clip_loss_fn``; parity:
    pipelines/clip.py:123-176 forward_loss, dispatching on cfg.loss.name;
    ``extra_losses`` add further terms on the same embeddings). MixUpNCE
    mixes each image with its mirror in the batch, as the JAX step does on
    one device."""
    if loss_name == "MixUpNCE":
        lam = mixup_lambda(seed, step, mixup_alpha_param)
        batch = dict(batch)
        batch["image"] = (lam * batch["image"]
                          + (1.0 - lam) * batch["image"].flip(0))

    img, txt, temp = model(batch, deterministic=deterministic)
    img, txt = img.float(), txt.float()
    ignore = batch.get("ignore_mask")

    def compute(name):
        if name == "NCE":
            return symmetric_info_nce(img, txt, temp, ignore_mask=ignore,
                                      smoothing=smoothing)
        if name == "MSE":
            i2t, i2t_acc = mse_embedding_loss(img, txt, ignore_mask=ignore)
            t2i, t2i_acc = mse_embedding_loss(txt, img, ignore_mask=ignore)
            return 0.5 * (i2t + t2i), {"i2t_acc": i2t_acc, "t2i_acc": t2i_acc}
        if name == "Triplet":
            loss, i2t_acc, t2i_acc = triplet_loss(img, txt, triplet_margin,
                                                  triplet_reduce)
            return loss, {"i2t_acc": i2t_acc, "t2i_acc": t2i_acc}
        raise NotImplementedError(f"loss '{name}'")

    if loss_name == "MixUpNCE":
        kw = dict(flip_block=img.shape[0], ignore_mask=ignore,
                  smoothing=smoothing)
        i2t, i2t_acc = mixup_nce(img, txt, temp, lam, **kw)
        t2i, t2i_acc = mixup_nce(txt, img, temp, lam, **kw)
        loss = 0.5 * (i2t + t2i)
        accs = {"i2t_acc": i2t_acc, "t2i_acc": t2i_acc}
    else:
        loss, accs = compute(loss_name)

    metrics = {"temperature": temp.detach(), **accs}
    for name in extra_losses:
        extra, _ = compute(name)
        loss = loss + extra
        metrics[f"{name.lower()}_loss"] = extra.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def make_train_step(model, optimizer, smoothing: float = 0.0,
                    loss_name: str = "NCE", **loss_kwargs) -> Callable:
    """``step_fn(batch, lr, step=0, deterministic=True) -> metrics``: one
    update of ``model`` by ``optimizer`` (``core/optim.py:Optimizer``).
    ``lr`` is the host-computed scalar from the stateless schedule (the
    reference's set_lrs-before-step contract, lr_scheduler.py:59-65).
    Metrics stay on the device; the caller materialises them."""

    def step_fn(batch: Dict[str, torch.Tensor], lr: float, step: int = 0,
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        loss, metrics = clip_loss_fn(model, batch, smoothing,
                                     loss_name=loss_name,
                                     deterministic=deterministic, step=step,
                                     **loss_kwargs)
        loss.backward()
        optimizer.set_lr(lr)
        metrics["grad_norm"] = optimizer.step()
        metrics["lr"] = lr
        return metrics

    return step_fn
