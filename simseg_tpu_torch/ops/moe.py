"""Switch-style top-1 Mixture-of-Experts MLP (port of
``simseg_tpu/ops/moe.py:44-128``, ``MoEMlp``) and expert parallelism.

The dense-dispatch formulation, with JAX's math:

- router: a float32 linear on x cast to float32, softmax over the E
  experts, the first maximum's expert (``torch.argmax`` returns the first
  maximal index, as ``jnp.argmax`` does) and its probability as the gate;
- routing groups are per sample: each expert takes at most
  C = max(ceil(T / E * capacity_factor), 1) tokens of a sample, in token
  order (slot = cumsum(assign) * assign - 1); the overflow is dropped and
  the block's residual carries it;
- ``token_mask`` (B, T) 0/1 takes padding out of routing, of the capacity
  and of the balance statistics, and its MoE output is zero;
- dispatch (B, T, E, C) one-hot in x's dtype -> expert inputs (B, E, C, D),
  the experts' FFN as two batched products with float32 ``w1`` (E, D, H),
  ``b1``, ``w2`` (E, H, D), ``b2`` cast to x's dtype, GELU exact in float32
  and tanh-approximated otherwise (JAX ``approximate=dtype != float32``),
  combine (dispatch times the gate) back to (B, T, D). The einsums are
  JAX's XLA einsums, not Pallas: ``torch.einsum`` (a ``bmm``) here too.

The Switch load-balance loss, E * sum_e f_e * P_e (f_e the share of tokens
routed to e, P_e the mean router probability of e; over real tokens under
a mask), is a statistic of the global batch in JAX, whose step sees the
whole batch under GSPMD. Each layer therefore keeps its batch's sums
(``stats``: tokens per expert, probability per expert, tokens routed) from
its last forward, and ``moe_aux`` sums them over the data ranks (the
probabilities differentiably) before it takes the products, summed over
the layers as JAX's step sums the sown values (the Switch convention).

Expert parallelism (``dist.moe_ep``; ``parallel/sharding.py`` cuts
``w1``/``b1``/``w2``/``b2`` over the data ranks of a gather group when the
expert count divides them, JAX ``ep_shardings``): each rank holds E / n
experts; its (B, E, C, D) buffer goes through an all-to-all that gathers
the batch and scatters the experts (``parallel/collectives.all_to_all``),
the rank runs its own experts on every rank's tokens, and a second
all-to-all brings the outputs back. The backward of each all-to-all is the
reverse one, so an expert's gradient already holds every rank's tokens and
is not reduced over the data ranks.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn

from simseg_tpu_torch.models.layers import Linear, gelu


class MoEMlp(nn.Module):
    """(B, T, D) -> (B, T, out_dim), a drop-in for the towers' MLPs."""

    def __init__(self, dim: int, num_experts: int, hidden_dim: int,
                 out_dim: int, capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.num_experts = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.router = Linear(dim, self.num_experts)
        e = self.num_experts
        self.w1 = nn.Parameter(torch.empty(e, dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(e, hidden_dim, out_dim))
        self.b2 = nn.Parameter(torch.zeros(e, out_dim))
        for w in (self.w1, self.w2):
            # flax's lecun_normal on (E, in, out): fan_in = E * in
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
        # the last forward's (tokens per expert (E,), probability per expert
        # (E,), tokens routed ()) for ``moe_aux``
        self.stats = None
        # expert parallelism (parallel/sharding.py): (group, ranks); the
        # parameters then hold this rank's E / ranks experts
        self.ep = None

    def capacity(self, tokens: int) -> int:
        return max(int(math.ceil(tokens / self.num_experts
                                 * self.capacity_factor)), 1)

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        e, cap = self.num_experts, self.capacity(x.shape[1])
        probs = torch.softmax(self.router(x.float()), dim=-1)      # (B, T, E)
        expert_idx = probs.argmax(dim=-1)
        gate = probs.amax(dim=-1)
        assign = torch.nn.functional.one_hot(expert_idx, e).float()
        p_sum = probs
        if token_mask is not None:
            keep = token_mask.float()
            assign = assign * keep[:, :, None]
            gate = gate * keep
            p_sum = probs * keep[:, :, None]
        # every routed token is one 1 of ``assign``
        self.stats = (assign.sum((0, 1)), p_sum.sum((0, 1)), assign.sum())
        # each token's slot in its expert's buffer of this sample; -1: none
        pos = torch.cumsum(assign, dim=1) * assign - 1.0
        slot = torch.where((pos >= 0) & (pos < cap), pos, -1.0)
        dispatch = (slot[..., None] == torch.arange(
            cap, device=x.device, dtype=slot.dtype)).to(x.dtype)   # (B, T, E, C)
        combine = dispatch * gate.to(x.dtype)[:, :, None, None]

        expert_in = torch.einsum("btec,btd->becd", dispatch, x)
        if self.ep is not None:
            from simseg_tpu_torch.parallel.collectives import all_to_all

            # batch gathered, experts scattered: (n B, E / n, C, D)
            expert_in = all_to_all(expert_in, 1, 0, self.ep[0])
        dtype = x.dtype
        h = torch.einsum("becd,edh->bech", expert_in, self.w1.to(dtype))
        h = gelu(h + self.b1.to(dtype)[None, :, None, :])
        out = torch.einsum("bech,ehd->becd", h, self.w2.to(dtype))
        out = out + self.b2.to(dtype)[None, :, None, :]
        if self.ep is not None:
            out = all_to_all(out, 0, 1, self.ep[0])
        return torch.einsum("btec,becd->btd", combine, out)


def moe_layers(model: nn.Module) -> List[MoEMlp]:
    return [m for m in model.modules() if isinstance(m, MoEMlp)]


def moe_aux(model: nn.Module, group=None, world: int = 1) -> Optional[torch.Tensor]:
    """The Switch aux loss of ``model``'s last forward, summed over its MoE
    layers, each layer's statistics summed over ``group`` (the data ranks,
    ``world`` of them; 1: one process) first; None without MoE layers. The
    layers' statistics are consumed."""
    layers = moe_layers(model)
    stats = [m.stats for m in layers if m.stats is not None]
    for m in layers:
        m.stats = None
    if not stats:
        return None
    # one collective each for every layer's counts and probabilities
    counts = torch.cat([torch.cat([c, r[None]]) for c, _, r in stats])
    probs = torch.cat([p for _, p, _ in stats])
    if world > 1:
        from simseg_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                           all_reduce_sum_grad)

        counts = all_reduce_sum(counts, group)
        probs = all_reduce_sum_grad(probs, group)
    aux, at = 0.0, 0
    for i, (c, _, _) in enumerate(stats):
        e = c.numel()
        denom = torch.clamp(counts[at + i + e], min=1.0)
        f = counts[at + i:at + i + e] / denom
        aux = aux + e * (f * (probs[at:at + e] / denom)).sum()
        at += e
    return aux
