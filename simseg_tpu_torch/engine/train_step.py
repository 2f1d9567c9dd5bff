"""The contrastive train step (port of ``simseg_tpu/engine/train_step.py``)
and the retrieval eval step.

Parity: reference hot loop ``tasks/clip/clip_runner.py:216-251``
(batch_processor: forward -> loss dict -> backward -> step). One step is
forward (the towers in the model's compute dtype), the loss in float32,
backward, the host-computed lr written into the optimizer, the optimizer
step (clipping and the non-finite guard inside), and the metrics
``grad_norm`` (before clipping) and ``lr``.

Over a ``torch.distributed`` world (``parallel/mesh.py:DataMesh``; None:
one process, where the global batch is the local batch) each rank runs
its rows of the global batch through the towers, and the loss is JAX's
loss of the global batch (``simseg_tpu/ops/losses.py``: the fused global
batch under pjit; the reference's GatherLayer):

- the embeddings (and ``ignore_mask``) are all-gathered
  (``parallel/collectives.all_gather``, whose backward sums the gathered
  gradient over the ranks and keeps this rank's rows); with
  ``loss.group_size`` gather groups, NCE and MixUpNCE gather within the
  rank's group, whose rows are one loss group, and the logged loss and
  accuracies are reduced over the world; MSE, Triplet and extra losses,
  which JAX computes on the whole batch, gather the world and take the
  groups as blocks (``group_size`` samples);
- every rank holds the same loss (of its group), so each backpropagates
  ``loss / W``, and the gradients summed over the ranks
  (``reduce_model_gradients``) are JAX's gradient of the global-batch loss, the
  temperature's included; the optimizer then clips, accumulates
  (``optim.grad_accum_steps``) and updates on that sum, as optax does on
  JAX's global gradient. ``loss.global_reduce`` and
  ``nce_loss.gather_backward`` are always on, as in JAX;
- MixUpNCE pairs each image with its mirror within the rank's rows
  (``mixup.pairing: shard``, JAX's ``_block_flip`` over the data shards)
  or within the global batch (``global``: the mirror rank's rows,
  reversed); the coefficient is the same on every rank.

A CNN image tower with ``bn_training`` (JAX's live-BN branch,
``simseg_tpu/engine/train_step.py:260-270``: the runner passes ``not
model.freeze_cnn_bn``) runs its BatchNorm on the batch's statistics and
moves its running averages in the forward (``models/layers.BatchNorm``);
in a world the statistics are the global batch's, as JAX's pjit forward
computes them (synchronised BN).

The sharded legs (``parallel/sharding.py``: TP, SP, FSDP, ZeRO-1) run
through the same step: the towers' collectives are in their layers, the
embeddings are gathered over the data ranks only (a model group's ranks
hold the same rows and embeddings), each data rank backpropagates ``loss /
D`` (D the data ranks) and ``reduce_model_gradients`` sums the gradients
as each leaf needs. Not ported: the PP and MoE branches (ROADMAP queue 1
item 13).

Dropout: with ``runner.stable_random`` set (``deterministic`` False) the
forward takes the step's key, JAX's ``fold_in(key(seed), step)``
(``step_key``), folded with the rank in a world of more than one rank
(``rank_key``: JAX draws one mask over the global batch, so the ranks'
rows never share a mask), from which each dropout site draws its mask
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
from simseg_tpu_torch.parallel.collectives import (all_gather, all_reduce_mean,
                                                   all_reduce_sum)
from simseg_tpu_torch.parallel.mesh import DataMesh
from simseg_tpu_torch.parallel.sharding import reduce_model_gradients
from simseg_tpu_torch.utils import threefry


# the fold tag of the draw (JAX ``MIXUP_FOLD_TAG``)
MIXUP_FOLD_TAG = 0x7FFFFFFF


def step_key(seed: int, step: int) -> threefry.Key:
    """The step's dropout key, JAX's ``fold_in(key(seed), step)``
    (``simseg_tpu/core/runner.py:189-191``)."""
    return threefry.fold_in(threefry.key(seed), step)


def rank_key(key: Optional[threefry.Key],
             mesh: Optional[DataMesh]) -> Optional[threefry.Key]:
    """This rank's dropout key: ``fold_in(key, data rank)`` over more than
    one data rank, else ``key`` (one process and a world of one draw the
    same masks). The ranks of a model group hold the same rows and draw the
    same masks, each site of a sharded tensor keeping its slice
    (``models/layers.Dropout``)."""
    if key is None or mesh is None or mesh.data_size == 1:
        return key
    return threefry.fold_in(key, mesh.data_rank)


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


def mixup_partner(images: torch.Tensor, mesh: Optional[DataMesh],
                  pairing: str = "shard") -> torch.Tensor:
    """The images each row is mixed with: this rank's rows reversed
    (``pairing`` 'shard', or one process), or under 'global' the rows the
    flip of the whole batch pairs with them, the mirror rank's reversed
    (JAX ``_block_flip`` with ``mixup_shards`` W or 1)."""
    if mesh is None or mesh.data_size == 1 or pairing == "shard":
        return images.flip(0)
    if pairing != "global":
        raise NotImplementedError(f"mixup.pairing '{pairing}'")
    b = images.shape[0]
    start = (mesh.data_size - 1 - mesh.data_rank) * b
    return all_gather(images.detach(), mesh.data_group)[start:start + b].flip(0)


def loss_gather(mesh: Optional[DataMesh], loss_name: str,
                extra_losses: Tuple[str, ...], group_size: int):
    """(group to gather the embeddings over, loss group size in samples of
    the gathered batch, whether the gather is a group's). NCE and MixUpNCE
    gather within the rank's gather group, whose rows form one loss group;
    the losses JAX computes over the whole batch gather every data rank and
    take the groups (``group_size``) as blocks."""
    if (mesh is not None and mesh.n_groups > 1
            and loss_name in ("NCE", "MixUpNCE") and not extra_losses):
        return mesh.group, -1, True
    return (None if mesh is None else mesh.data_group), group_size, False


def world_metrics(metrics: Dict[str, torch.Tensor], valid: torch.Tensor,
                  mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """A gather group's loss and accuracies made the global batch's: the
    loss the mean of the groups' (each the mean of as many rows), each
    accuracy the hits over the valid rows summed over the world."""
    out = dict(metrics)
    group = mesh.data_group
    out["loss"] = all_reduce_mean(metrics["loss"], group)
    denom = torch.clamp(all_reduce_sum(valid, group), min=1.0)
    for k in ("i2t_acc", "t2i_acc"):
        out[k] = all_reduce_sum(metrics[k] * torch.clamp(valid, min=1.0),
                                group) / denom
    return out


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
    mesh: Optional[DataMesh] = None,
    group_size: int = -1,
    mixup_pairing: str = "shard",
    bn_training: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + contrastive loss of the global batch (JAX ``clip_loss_fn``;
    parity: pipelines/clip.py:123-176 forward_loss, dispatching on
    cfg.loss.name; ``extra_losses`` add further terms on the same
    embeddings). ``batch`` holds this rank's rows; ``mesh`` the world (None:
    one process); ``group_size`` the loss groups in samples
    (``parallel/mesh.loss_group_samples``). MixUpNCE mixes each image with
    its partner (``mixup_partner``); ``bn_training``: a CNN tower's live
    BatchNorm."""
    key = None if deterministic else step_key(seed, step)
    if loss_name == "MixUpNCE":
        if mixup_pairing == "global" and group_size > 0:
            raise ValueError("mixup flip blocks must nest inside group_size "
                             "groups: mixup.pairing 'global' flips the whole "
                             "batch")
        lam = mixup_lambda(key, step, mixup_alpha_param)
        batch = dict(batch)
        batch["image"] = (lam * batch["image"] + (1.0 - lam)
                          * mixup_partner(batch["image"], mesh, mixup_pairing))

    img, txt, temp = model(batch, deterministic=deterministic,
                           key=rank_key(key, mesh), train_bn=bn_training)
    img, txt = img.float(), txt.float()
    ignore = batch.get("ignore_mask")
    local_rows = img.shape[0]
    group, group_size, in_group = loss_gather(mesh, loss_name, extra_losses,
                                              group_size)
    if mesh is not None:
        img, txt = all_gather(img, group), all_gather(txt, group)
        if ignore is not None:
            ignore = all_gather(ignore, group)

    def compute(name):
        if name == "NCE":
            return symmetric_info_nce(img, txt, temp, ignore_mask=ignore,
                                      smoothing=smoothing, group_size=group_size)
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
        kw = dict(flip_block=local_rows if mixup_pairing == "shard" else
                  img.shape[0], ignore_mask=ignore, smoothing=smoothing,
                  group_size=group_size)
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
    if in_group:
        valid = (torch.ones(img.shape[0], device=img.device) if ignore is None
                 else (ignore < 1).float()).sum()
        metrics = world_metrics(metrics, valid, mesh)
    return loss, metrics


def make_train_step(model, optimizer, smoothing: float = 0.0,
                    loss_name: str = "NCE", mesh: Optional[DataMesh] = None,
                    **loss_kwargs) -> Callable:
    """``step_fn(batch, lr, step=0, deterministic=True) -> metrics``: one
    update of ``model`` by ``optimizer`` (``core/optim.py:Optimizer``) from
    the gradient of the global batch over ``mesh`` (None: one process).
    ``lr`` is the host-computed scalar from the stateless schedule (the
    reference's set_lrs-before-step contract, lr_scheduler.py:59-65).
    Metrics stay on the device; the caller materialises them."""

    def step_fn(batch: Dict[str, torch.Tensor], lr: float, step: int = 0,
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        loss, metrics = clip_loss_fn(model, batch, smoothing,
                                     loss_name=loss_name,
                                     deterministic=deterministic, step=step,
                                     mesh=mesh, **loss_kwargs)
        if mesh is None:
            loss.backward()
        else:
            # every data rank holds the loss: each backpropagates its share
            (loss / mesh.data_size).backward()
            reduce_model_gradients(model, mesh)
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
