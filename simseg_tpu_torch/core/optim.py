"""Optimizer construction: AdamW / Adam / SGD over ``torch.optim`` and LARS
with per-parameter group rules, frozen patterns, gradient clipping, a
non-finite guard and a host-driven LR (port of ``simseg_tpu/core/optim.py``).

Parity: reference ``simseg/core/hooks/optimizer.py:90-118`` (optimizer by
name), ``simseg/tasks/clip/hooks/optimizer.py:14-36`` (regex
``optim.param_group_rules`` overriding lr / weight decay per parameter) and
``simseg/core/optimizer/lars.py`` (LARS; in JAX ``optax.lars``, ``LARS``
below).
The JAX version builds an optax chain; this one keeps its semantics:

- rules and frozen patterns are regexes over the JAX package's parameter
  paths (``params/image_encoder/blocks_0/attn/qkv/kernel``); each port
  parameter is matched under the path ``checkpoint/convert.py:
  flax_param_path`` gives it, so one YAML selects the same tensors in both
  packages. First matching frozen pattern, then first matching rule, else
  'default';
- a frozen parameter still gets its gradient (it counts in the global norm,
  as the JAX grads do) but no update and no weight decay (optax
  ``set_to_zero``);
- ``grad_clip.max_norm`` scales all gradients by max_norm / norm when the
  global norm reaches it (optax ``clip_by_global_norm``);
- ``skip_nonfinite = N`` skips the update, optimizer state untouched, while
  a step's gradients are not all finite, for up to N consecutive steps,
  then lets it through (optax ``apply_if_finite``);
- ``set_lr(lr)`` writes the schedule's lr times each group's multiplier;
- ``grad_accum_steps = k`` is optax ``MultiSteps`` around all of the above
  (``simseg_tpu/core/optim.py:160-171``): each step's gradients go into a
  running mean (``acc + (g - acc) / (n + 1)``, as optax computes it), and
  only the k-th step clips, guards and updates, on that mean, so the inner
  optimizer's state (AdamW's count and moments, the guard's count) moves
  once in k steps, with the lr set for that step. The mean starts again
  from zero after each update (optax multiplies it by zero, which keeps a
  NaN: the port does not carry a non-finite window into the next one).
  The mean and the mini-step are in ``state_dict``, so a run resumed in the
  middle of an accumulation goes on as the uninterrupted run.

Adam's and SGD's weight decay are coupled L2, as torch's own (the JAX
version adds ``add_decayed_weights`` ahead of optax's transform for the
same reason); AdamW's is decoupled.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from simseg_tpu_torch.checkpoint.convert import flax_param_path

logger = logging.getLogger(__name__)

# torch-style names accepted for reference-config compatibility
_NAME_ALIASES = {
    "torch.optim.AdamW": "adamw",
    "torch.optim.Adam": "adam",
    "torch.optim.SGD": "sgd",
    "LARS": "lars",
}


def _optimizer_class(name: str, opt_param: dict):
    """(torch.optim class, its keyword arguments other than lr and weight
    decay)."""
    name = _NAME_ALIASES.get(name, name).lower()
    if name in ("adamw", "adam"):
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        return cls, dict(betas=tuple(opt_param.get("betas", (0.9, 0.999))),
                         eps=opt_param.get("eps", 1e-8))
    if name == "sgd":
        return torch.optim.SGD, dict(momentum=opt_param.get("momentum", 0.9))
    if name == "lars":
        return LARS, dict(momentum=opt_param.get("momentum", 0.9),
                          trust_coefficient=opt_param.get("trust_coefficient",
                                                          0.001))
    raise NotImplementedError(f"optimizer '{name}'")


class LARS(torch.optim.Optimizer):
    """``optax.lars`` (``simseg_tpu/core/optim.py:75-81``) in optax's order,
    per parameter tensor, in float32:

    1. u = g + weight_decay · p (``add_decayed_weights``, biases included);
    2. u = u · trust_coefficient · |p| / |u| (``scale_by_trust_ratio``,
       eps 0; Frobenius norms, which a transposed kernel keeps), the ratio
       1 where either norm is 0 (a zero-initialised bias on its first step);
    3. u = -lr · u;
    4. trace = u + momentum · trace, p = p + trace (``trace``).

    The learning rate enters before the momentum: under a changing lr this
    is not SGD-style LARS, whose trace holds lr-free updates."""

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001
                 ) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad.float()
                if wd:
                    u = u + wd * p.float()
                p_norm = torch.linalg.vector_norm(p.float())
                u_norm = torch.linalg.vector_norm(u)
                ratio = group["trust_coefficient"] * p_norm / u_norm
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(ratio), ratio)
                u = -lr * (u * ratio)
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(u)
                trace = state["trace"]
                trace.mul_(group["momentum"]).add_(u)
                p.add_(trace.to(p.dtype))


def _rule_pattern(rule: dict) -> str:
    # both the JAX package's 'pattern' key and the reference's 'regex'
    return rule.get("pattern") or rule["regex"]


def param_label(path: str, rules: Dict[str, dict],
                frozen_patterns: Sequence[str] = ()) -> str:
    """'_frozen', the first matching rule's name, or 'default' for a
    parameter's JAX path (JAX ``_param_labels``)."""
    if any(re.search(p, path) for p in frozen_patterns):
        return "_frozen"
    for rule_name, rule in rules.items():
        if re.search(_rule_pattern(rule), path):
            return rule_name
    return "default"


class Optimizer:
    """A ``torch.optim`` optimizer over labelled parameter groups, with the
    JAX chain's clipping, non-finite guard and per-group lr multipliers."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 base: torch.optim.Optimizer, max_norm: Optional[float] = None,
                 skip_nonfinite: int = 0, accum_steps: int = 1) -> None:
        self.params: List[torch.nn.Parameter] = [p for _, p in named_params]
        self.base = base
        self.max_norm = max_norm
        self.skip_nonfinite = skip_nonfinite
        self.notfinite_count = 0
        self.accum_steps = accum_steps
        self.mini_step = 0
        # the running mean of the steps' gradients (accum_steps > 1)
        self.acc: Optional[List[torch.Tensor]] = None

    def set_lr(self, lr: float) -> None:
        for group in self.base.param_groups:
            group["lr"] = lr * group["lr_mult"]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a missing grad is a
        zero), or under ``accum_steps`` one step of the accumulation;
        returns the global norm of this step's gradients before clipping,
        as a float32 scalar tensor, and clears the gradients."""
        norm = _global_norm([p.grad for p in self.params if p.grad is not None])
        if self.accum_steps == 1:
            self._update(norm)
        elif self._accumulate():
            self._update(_global_norm([p.grad for p in self.params]))
        self.zero_grad()
        return norm

    def _accumulate(self) -> bool:
        """Adds the gradients to the running mean; on the k-th step puts the
        mean in ``.grad``, restarts the mean and returns True."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            g = torch.zeros_like(acc) if p.grad is None else p.grad
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.accum_steps
        if self.mini_step:
            return False
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
            acc.zero_()
        return True

    def _update(self, norm: torch.Tensor) -> None:
        """Clipping (by ``norm``, the gradients' global norm), the
        non-finite guard and the base step on ``.grad``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        apply = True
        if self.skip_nonfinite > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            apply = finite or self.notfinite_count > self.skip_nonfinite
        if apply:
            if self.max_norm:
                scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                    self.max_norm / norm)
                torch._foreach_mul_(grads, scale)
            self.base.step()

    def state_dict(self) -> dict:
        state = {"base": self.base.state_dict(),
                 "notfinite_count": self.notfinite_count}
        if self.accum_steps > 1:
            state["mini_step"] = self.mini_step
            state["acc"] = None if self.acc is None else [
                a.clone() for a in self.acc]
        return state

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state["base"])
        self.notfinite_count = int(state.get("notfinite_count", 0))
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device, p.dtype).clone() for a, p in zip(acc, self.params)]


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def build_optimizer(cfg, model: torch.nn.Module,
                    frozen_patterns: Sequence[str] = ()) -> Optimizer:
    """The optimizer of ``cfg.optim`` over ``model``'s parameters (JAX
    ``build_optimizer``; ``frozen_patterns`` are the runner's tower
    gates)."""
    opt_param = dict(cfg.optim.get("param", {}))
    weight_decay = opt_param.get("weight_decay", 0.0)
    base_lr = cfg.optim.get("lr", {}).get("init", None)
    rules = dict(cfg.optim.get("param_group_rules", {}) or {})
    cls, kwargs = _optimizer_class(cfg.optim.name, opt_param)

    named = list(model.named_parameters())
    by_label: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in named:
        label = param_label(flax_param_path(name), rules, frozen_patterns)
        by_label.setdefault(label, []).append(p)

    groups = []
    for label in ["default", *rules]:
        if label not in by_label:
            continue
        wd, mult = weight_decay, 1.0
        if label != "default":
            rule = rules[label]
            rp = dict(rule.get("param", {}) or {})
            wd = rule.get("weight_decay", rp.get("weight_decay", weight_decay))
            if "lr_mult" in rule:
                mult = rule["lr_mult"]
            elif "lr" in rp and base_lr:
                mult = rp["lr"] / base_lr
        groups.append(dict(params=by_label[label], weight_decay=wd,
                           lr_mult=mult, name=label))
    if rules or frozen_patterns:
        logger.info("Optimizer param groups: %s",
                    sorted(g["name"] for g in groups)
                    + (["_frozen"] if "_frozen" in by_label else []))
    base = cls(groups, lr=0.0, **kwargs)
    clip = cfg.optim.get("grad_clip", {}) or {}
    return Optimizer(named, base, max_norm=clip.get("max_norm", None),
                     skip_nonfinite=cfg.optim.get("skip_nonfinite", 0) or 0,
                     accum_steps=int(cfg.optim.get("grad_accum_steps", 1) or 1))
