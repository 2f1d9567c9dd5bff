"""The contrastive train step (port of ``simseg_tpu/engine/train_step.py``,
single device; and the retrieval eval step).

Parity: reference hot loop ``tasks/clip/clip_runner.py:216-251``
(batch_processor: forward -> loss dict -> backward -> step). One step is
forward (the towers in the model's compute dtype), the loss in float32,
backward, the host-computed lr written into the optimizer, the optimizer
step (clipping and the non-finite guard inside), and the metrics
``grad_norm`` (before clipping) and ``lr``.

On one card the global batch is the local batch, so the all-gather of
negatives is the identity. Not ported yet: the mesh, ZeRO-1, FSDP, TP, PP,
MoE and live-BN branches (ROADMAP queue 1 items 8 and 13).

Dropout: with ``runner.stable_random`` set (``deterministic`` False) the
forward takes the step's key, JAX's ``fold_in(key(seed), step)``
(``step_key``), from which each dropout site draws its mask
(``models/layers.py``); BSGS (``engine/bsgs.py``) folds the micro-batch's
index into the same key, so the two runners share one dropout scheme.

The attention kernels' training lane needs no marker: autograd knows that
a call is differentiated (``ops/attention.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from simseg_tpu_torch.ops.losses import (mixup_nce, mse_embedding_loss,
                                         symmetric_info_nce, triplet_loss)
from simseg_tpu_torch.utils import threefry


# the fold tag of the draw (JAX ``MIXUP_FOLD_TAG``)
MIXUP_FOLD_TAG = 0x7FFFFFFF


def step_key(seed: int, step: int) -> threefry.Key:
    """The step's dropout key, JAX's ``fold_in(key(seed), step)``
    (``simseg_tpu/core/runner.py:189-191``)."""
    return threefry.fold_in(threefry.key(seed), step)


def mixup_lambda(key: Optional[threefry.Key], step: int, alpha: float) -> float:
    """Per-step Beta(alpha, alpha) mixup coefficient in [0.5, 1], JAX's
    ``mixup_lambda(rng, step, alpha)`` (``simseg_tpu/engine/train_step.py:
    56-66``) computed on the host (``utils/threefry.py``): the step key
    (``step_key``) folded with the tag; without a key
    (``runner.stable_random`` off), ``fold_in(key(0), step)``."""
    if key is not None:
        k = threefry.fold_in(key, MIXUP_FOLD_TAG)
    else:
        k = threefry.fold_in(threefry.key(0), step)
    lam = float(threefry.beta(k, alpha, alpha))
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
    key = None if deterministic else step_key(seed, step)
    if loss_name == "MixUpNCE":
        lam = mixup_lambda(key, step, mixup_alpha_param)
        batch = dict(batch)
        batch["image"] = (lam * batch["image"]
                          + (1.0 - lam) * batch["image"].flip(0))

    img, txt, temp = model(batch, deterministic=deterministic, key=key)
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


def make_eval_step(model) -> Callable:
    """``eval_fn(batch) -> (image_emb, text_emb)`` in float32 for retrieval
    validation (JAX ``make_eval_step``, ``simseg_tpu/engine/train_step.py:
    447-460``): the model in eval mode under ``torch.no_grad``, its mode
    restored after."""

    def eval_fn(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                img, txt, _ = model(batch, deterministic=True)
        finally:
            model.train(was_training)
        return img.float(), txt.float()

    return eval_fn
