"""BSGS: the exact full-batch contrastive gradient at micro-batch memory
(port of ``simseg_tpu/engine/bsgs.py``).

Parity: reference ``simseg/tasks/clip/clip_bsgs_runner.py:309-451``
(decoupled gradient accumulation), as the JAX package computes it:

1. pass 1 embeds the whole batch micro-batch by micro-batch under
   ``torch.no_grad()``, the embeddings in float32;
2. the middle section is float32 algebra over the whole batch
   (``simseg_tpu/engine/bsgs.py:154-208``): the per-group softmaxes, the
   soft targets (smoothing, and the mixup flip within each micro-batch),
   the ``ignore_mask`` D-sandwich, the left matrices
   ``left_I = diag(w) (P_i2t - Y + (P_t2i - Y)^T) diag(w) E_text / sqrt(T)``
   (and symmetrically for text), and the logged loss and accuracies;
3. pass 2 runs each micro-batch forward again with autograd and backprops
   the surrogate ``sum(left . emb) / 2 / B / sqrt(T)``; the gradients add up
   in the parameters' ``.grad``. Its gradient equals the InfoNCE gradient of
   the whole batch for every parameter, the learnable temperature included
   (through the re-forward's 1 / sqrt(T)).

Over a ``torch.distributed`` world (``mesh``; JAX ``bsgs.py:242-323``,
BSGS on a data mesh) each rank holds its rows of the global batch, in
micro-batches of its own: pass 1 embeds them, the float32 middle section
runs on the embeddings all-gathered over the world (or over the rank's
``loss.group_size`` gather group, whose rows are one loss group) with the
global batch as the divisor, pass 2 re-forwards the rank's micro-batches
with its rows of the left matrices, and the gradients are summed over the
ranks once per step (``parallel/sharding.reduce_model_gradients``). The
logged loss and accuracies are the global batch's. Under mixup the flip
blocks are the micro-batches, each on one rank, as in JAX where a
micro-batch is a contiguous block of the global batch.

On the sharded legs (JAX ``make_bsgs_train_step`` with TP, ZeRO-1 and
FSDP) "rank" above is a data rank: the ranks of a model group run both
passes together on the same rows (the towers' collectives in their
layers), the middle section runs the same on each of them, FSDP's
gradients are reduce-scattered in each micro-batch's backward, and the
optimizer holds its shards (``core/optim.py``).

Dropout: micro-batch i runs with the key ``fold_in(key, i)`` in both
passes (JAX ``bsgs.py:126-127``), and every dropout site seeds its own
draw from it (``models/layers.py``), so pass 2 replays pass 1's masks.

Attention routing follows autograd (``ops/attention.py``): pass 1, without
grad, takes the inference lane, as JAX's pass 1 does outside
``attention_training()`` (``bsgs.py:223-227``), and pass 2 the train lane.
At 576 px (T = 1297) pass 1 launches the forward kernel without its
log-sum-exp and pass 2 the forward with it and then the backward kernel.
At 640 px (T = 1601) pass 1 takes the plain attention (the row-block lane
starts above ``_ROWBLOCK_MIN_INFER`` = 1680 in inference) and pass 2 the
row-block lane: JAX's routing, kept.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from simseg_tpu_torch.engine.train_step import (mixup_lambda, rank_key,
                                                step_key)
from simseg_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from simseg_tpu_torch.parallel.mesh import DataMesh
from simseg_tpu_torch.parallel.sharding import reduce_model_gradients
from simseg_tpu_torch.utils import threefry

_BATCH_KEYS = ("image", "input_ids", "attention_mask")


def split_micro(batch: Dict[str, torch.Tensor],
                num_micro: int) -> List[Dict[str, torch.Tensor]]:
    """``num_micro`` equal slices of the model's inputs along the batch
    (JAX ``_split_micro``)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(num_micro)]
    for k in _BATCH_KEYS:
        if k in batch:
            x = batch[k]
            if x.shape[0] % num_micro != 0:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                 f"num_micro {num_micro}")
            for mb, part in zip(out, x.chunk(num_micro)):
                mb[k] = part
    return out


def flip_within_blocks(n: int, block: int) -> np.ndarray:
    """Permutation j(i) reversing each contiguous block (the reference's
    block_diag of flipped eyes, clip_bsgs_runner.py:372)."""
    i = np.arange(n)
    return (i // block) * block + (block - 1 - i % block)


def embed_micro(model, mbatch: Dict[str, torch.Tensor],
                key: Optional[threefry.Key], lam: Optional[float]):
    """(image, text) embeddings in float32 and the temperature of one
    micro-batch; under mixup its images mixed with their mirror within it."""
    if lam is not None:
        mbatch = dict(mbatch)
        mbatch["image"] = lam * mbatch["image"] + (1.0 - lam) * mbatch["image"].flip(0)
    img, txt, temp = model(mbatch, deterministic=key is None, key=key)
    return img.float(), txt.float(), temp


def reforward(model, micro, keys, lam, left_i, left_t, b: int) -> None:
    """Pass 2: each micro-batch forward with autograd, backpropagating
    ``sum(left_i . img + left_t . txt) / 2 / b / sqrt(T)``; ``left_i`` and
    ``left_t`` hold the micro-batches' rows in their order."""
    n = len(micro)
    for mb, key, li, lt in zip(micro, keys, left_i.chunk(n), left_t.chunk(n)):
        img, txt, temp = embed_micro(model, mb, key, lam)
        value = torch.sum(li * img + lt * txt) / 2.0 / b
        (value / torch.sqrt(temp)).backward()


def make_bsgs_grad_fn(model, num_micro: int, smoothing: float = 0.0,
                      group_size: int = -1, mixup: bool = False,
                      mixup_alpha_param: float = 0.2,
                      mesh: Optional[DataMesh] = None) -> Callable:
    """``grad_fn(batch, key=None, step=0) -> metrics``: the exact symmetric
    InfoNCE gradient of the whole batch put in the parameters' ``.grad``
    (cleared first), by two passes over ``num_micro`` micro-batches. ``key``
    is the step's dropout key (``train_step.step_key``; None: no dropout);
    the metrics (``loss``, ``temperature``, ``i2t_acc``, ``t2i_acc``) stay on
    the device.

    group_size: negatives restricted to contiguous groups of this many
    samples (block-diagonal loss). mixup: image mixup with the reversed
    pairing within each micro-batch, the coefficient JAX's draw
    (``mixup_lambda``). mesh: the world (None: one process); ``batch`` then
    holds this rank's rows, split into ``num_micro`` micro-batches, and
    ``group_size`` is met by the gather group."""

    def grad_fn(batch: Dict[str, torch.Tensor],
                key: Optional[threefry.Key] = None, step: int = 0):
        rows = batch["image"].shape[0]
        mb_size = rows // num_micro
        micro = split_micro(batch, num_micro)
        lam = mixup_lambda(key, step, mixup_alpha_param) if mixup else None
        rkey = rank_key(key, mesh)
        keys = [None if rkey is None else threefry.fold_in(rkey, i)
                for i in range(num_micro)]
        for p in model.parameters():
            p.grad = None

        # ---- pass 1: grad-free embeddings (clip_bsgs_runner.py:331-349)
        with torch.no_grad():
            outs = [embed_micro(model, mb, k, lam) for mb, k in zip(micro, keys)]
        img_g = torch.cat([o[0] for o in outs])
        txt_g = torch.cat([o[1] for o in outs])
        temp = outs[0][2].float()
        dev = img_g.device
        mask = batch.get("ignore_mask")
        w = (torch.ones(rows, device=dev) if mask is None
             else 1.0 - mask.to(dev, torch.float32))
        b, first, gsize = rows, 0, group_size
        if mesh is not None:
            # the middle section over the gathered batch: every data
            # rank's, or the rank's gather group's (one loss group)
            grouped = mesh.n_groups > 1
            img_g, txt_g, w = (all_gather(x, mesh.gather_group)
                               for x in (img_g, txt_g, w))
            b = rows * mesh.data_size
            first = rows * (mesh.rank_in_group if grouped else mesh.data_rank)
            gsize = -1
        n = img_g.shape[0]
        g = gsize if (gsize and 0 < gsize < n) else n
        if n % g != 0:
            raise ValueError(f"group_size {g} must divide batch {n}")
        if mixup and g % mb_size != 0 and g != n:
            raise ValueError(
                "mixup flip blocks (micro-batches) must nest inside "
                f"group_size groups: micro {mb_size}, group {g}")
        ng = n // g
        d = img_g.shape[-1]

        # ---- analytic softmax gradients (clip_bsgs_runner.py:358-396), by
        # group (g == n: one group, global negatives); masked rows are
        # zeroed in the second operand of the logits (info_nce parity)
        i_blk = img_g.reshape(ng, g, d)
        t_blk = txt_g.reshape(ng, g, d)
        w_blk = w.reshape(ng, g)
        im_blk = i_blk * w_blk[:, :, None]
        tm_blk = t_blk * w_blk[:, :, None]
        s1 = torch.bmm(i_blk, tm_blk.transpose(1, 2)) / temp
        s2 = torch.bmm(t_blk, im_blk.transpose(1, 2)) / temp
        p1 = torch.softmax(s1, dim=-1)
        p2 = torch.softmax(s2, dim=-1)

        # soft targets per group: the mixup flip, then smoothing (CE is
        # linear in the target: Y = (1 - sm) Y_mix + sm / g)
        eye = torch.eye(g, device=dev)
        if mixup:
            flip = torch.zeros(g, g, device=dev)
            flip[torch.arange(g), torch.from_numpy(
                flip_within_blocks(g, mb_size)).to(dev)] = 1.0
            y = lam * eye + (1.0 - lam) * flip
        else:
            y = eye
        if smoothing > 0:
            y = (1.0 - smoothing) * y + smoothing / g

        # D-sandwich: dL/dI = (1 / 2B temp) diag(w)(A1 + A2^T)diag(w) T
        ww = w_blk[:, :, None] * w_blk[:, None, :]
        a1, a2 = p1 - y, p2 - y
        mid_i = (a1 + a2.transpose(1, 2)) * ww
        mid_t = (a2 + a1.transpose(1, 2)) * ww
        temp_sqrt = torch.sqrt(temp)
        left_i = (torch.bmm(mid_i, t_blk) / temp_sqrt).reshape(n, d)
        left_t = (torch.bmm(mid_t, i_blk) / temp_sqrt).reshape(n, d)

        # the logged loss (clip_bsgs_runner.py:369): the autodiff objective,
        # masks, smoothing and mixup included
        row1 = -torch.sum(y * torch.log_softmax(s1, dim=-1), dim=-1) * w_blk
        row2 = -torch.sum(y * torch.log_softmax(s2, dim=-1), dim=-1) * w_blk
        loss = 0.5 * (row1.sum() + row2.sum()) / b
        tgt = torch.arange(g, device=dev)
        hits1 = ((s1.argmax(dim=-1) == tgt).float() * w_blk).sum()
        hits2 = ((s2.argmax(dim=-1) == tgt).float() * w_blk).sum()
        valid = w_blk.sum()
        if mesh is not None and mesh.n_groups > 1:
            # each group's sums, counted once by each of its ranks
            loss, hits1, hits2, valid = (
                all_reduce_sum(x, mesh.data_group) / mesh.group_ranks
                for x in (loss, hits1, hits2, valid))
        denom = torch.clamp(valid, min=1.0)

        # ---- pass 2: the surrogate re-forward with grads (:404-438), on
        # this rank's rows of the left matrices
        reforward(model, micro, keys, lam, left_i[first:first + rows],
                  left_t[first:first + rows], b)
        reduce_model_gradients(model, mesh)
        return {"loss": loss, "temperature": temp,
                "i2t_acc": hits1 / denom, "t2i_acc": hits2 / denom}

    return grad_fn


def make_bsgs_train_step(model, optimizer, num_micro: int,
                         smoothing: float = 0.0, group_size: int = -1,
                         mixup: bool = False, mixup_alpha_param: float = 0.2,
                         seed: int = 0, mesh: Optional[DataMesh] = None
                         ) -> Callable:
    """``step_fn(batch, lr, step=0, deterministic=True) -> metrics``, the
    plain step's contract (``train_step.make_train_step``): the BSGS
    gradient, then one update of ``optimizer`` (``core/optim.py``), with
    ``grad_norm`` (before clipping) and ``lr`` added to the metrics
    (JAX ``make_bsgs_train_step``, :242-278). Not deterministic: the dropout
    key of ``seed`` and ``step``."""
    grad_fn = make_bsgs_grad_fn(model, num_micro, smoothing,
                                group_size=group_size, mixup=mixup,
                                mixup_alpha_param=mixup_alpha_param, mesh=mesh)

    def step_fn(batch: Dict[str, torch.Tensor], lr: float, step: int = 0,
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        key = None if deterministic else step_key(seed, step)
        metrics = grad_fn(batch, key, step)
        optimizer.set_lr(lr)
        metrics["grad_norm"] = optimizer.step()
        metrics["lr"] = lr
        return metrics

    return step_fn
