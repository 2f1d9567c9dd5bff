"""The plain reference of a CLIP pretraining step as SimSeg's recipe defines
it (``configs/clip/simseg.vit-b.yaml``): LoDA-pooled embeddings of both
towers, the symmetric InfoNCE loss over the batch at the learned
temperature, autograd's gradients, and torch's AdamW update written out
(decoupled weight decay, bias-corrected moments), at the learning rate of
the cosine schedule with warm-up and a floor (``lr``)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch
import torch.nn.functional as F

from pbench_ref.clip import Ref, normalise


def lr(step: int, init: float, warmup_proportion: float, total_steps: int,
       num_cycles: float, min_lr_scale: float) -> float:
    """The learning rate of ``step``: linear warm-up over
    int(warmup_proportion * total_steps) steps, then a cosine from init to
    init * min_lr_scale."""
    warm = int(warmup_proportion * total_steps)
    if step < warm:
        return init * float(step) / float(max(1.0, warm))
    progress = float(step - warm) / float(max(1, total_steps - warm))
    scale = min_lr_scale + (1.0 - min_lr_scale) * 0.5 * (
        1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
    return init * max(0.0, scale)


def embed(ref: Ref, batch: Dict[str, torch.Tensor], mean, std, image_k: int,
          text_k: int):
    """The batch's image and text embeddings, L2-normalised."""
    patches = ref.image_tokens(normalise(batch["image"], mean, std))[:, 1:]
    img = ref.image_embed(patches, image_k)
    txt = ref.text_embed(batch["input_ids"], batch["attention_mask"], text_k)
    return img, txt


def loss(img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor
         ) -> torch.Tensor:
    """0.5 (CE(I T^T / t) + CE(T I^T / t)), the targets on the diagonal."""
    logits = img @ txt.t() / temperature
    target = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, target)
                  + F.cross_entropy(logits.t(), target))


class AdamW:
    """torch.optim.AdamW's update, one tensor at a time."""

    def __init__(self, params: Dict[str, torch.Tensor], betas, eps: float,
                 weight_decay: float):
        self.p = params
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(self.m[k], self.v[k].sqrt().div_(c2).add_(self.eps),
                       value=-lr / c1)


# an element whose gradient stays under this share of the median tensor's
# root-mean-square first gradient in every followed step moves under Adam
# by round-off alone
MOVED_SHARE = 1e-3


def follow(ref: Ref, batches: List[Dict[str, torch.Tensor]], lrs: List[float],
           opt: AdamW, mean, std, image_k: int, text_k: int) -> dict:
    """Steps over ``batches`` from the parameters as they are: each step's
    loss, the first step's embeddings and gradient norm per tensor, each
    tensor's change after the last step, and
    ``moved``: a mask a tensor of the elements whose gradient reaches
    ``MOVED_SHARE`` of the median tensor's root-mean-square first gradient
    in some step."""
    start = {k: v.detach().clone() for k, v in ref.p.items()}
    losses, first, emb, moved, floor = [], None, None, None, None
    for i, (batch, rate) in enumerate(zip(batches, lrs)):
        for v in ref.p.values():
            v.grad = None
        img, txt = embed(ref, batch, mean, std, image_k, text_k)
        value = loss(img, txt, ref.temperature())
        value.backward()
        grads = {k: v.grad for k, v in ref.p.items()}
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
            emb = (img.detach(), txt.detach())
            floor = MOVED_SHARE * statistics.median(
                n / max(1, grads[k].numel()) ** 0.5 for k, n in first.items())
            moved = {k: g.abs() >= floor for k, g in grads.items()}
        else:
            for k, g in grads.items():
                moved[k] |= g.abs() >= floor
        losses.append(float(value.detach()))
        opt.step(grads, rate)
    change = {k: ref.p[k].detach() - start[k] for k in ref.p}
    return {"loss": losses, "grad_norm": first, "change": change, "embed": emb,
            "moved": moved}
