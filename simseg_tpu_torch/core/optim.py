"""Optimizer construction: AdamW / Adam / SGD over ``torch.optim`` with
per-parameter group rules, frozen patterns, gradient clipping, a
non-finite guard and a host-driven LR (port of ``simseg_tpu/core/optim.py``).

Parity: reference ``simseg/core/hooks/optimizer.py:90-118`` (optimizer by
name) and ``simseg/tasks/clip/hooks/optimizer.py:14-36`` (regex
``optim.param_group_rules`` overriding lr / weight decay per parameter).
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
- ``set_lr(lr)`` writes the schedule's lr times each group's multiplier.

Adam's and SGD's weight decay are coupled L2, as torch's own (the JAX
version adds ``add_decayed_weights`` ahead of optax's transform for the
same reason); AdamW's is decoupled. LARS and ``grad_accum_steps > 1`` are
not ported yet.
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
        raise NotImplementedError("LARS is not ported yet (ROADMAP queue 1 "
                                  "item 11)")
    raise NotImplementedError(f"optimizer '{name}'")


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
                 skip_nonfinite: int = 0) -> None:
        self.params: List[torch.nn.Parameter] = [p for _, p in named_params]
        self.base = base
        self.max_norm = max_norm
        self.skip_nonfinite = skip_nonfinite
        self.notfinite_count = 0

    def set_lr(self, lr: float) -> None:
        for group in self.base.param_groups:
            group["lr"] = lr * group["lr_mult"]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a missing grad is a
        zero); returns the global gradient norm before clipping, as a
        float32 scalar tensor, and clears the gradients."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
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
        self.zero_grad()
        return norm

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(),
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state["base"])
        self.notfinite_count = int(state.get("notfinite_count", 0))


def build_optimizer(cfg, model: torch.nn.Module,
                    frozen_patterns: Sequence[str] = ()) -> Optimizer:
    """The optimizer of ``cfg.optim`` over ``model``'s parameters (JAX
    ``build_optimizer``; ``frozen_patterns`` are the runner's tower
    gates)."""
    opt_param = dict(cfg.optim.get("param", {}))
    weight_decay = opt_param.get("weight_decay", 0.0)
    base_lr = cfg.optim.get("lr", {}).get("init", None)
    rules = dict(cfg.optim.get("param_group_rules", {}) or {})
    if int(cfg.optim.get("grad_accum_steps", 1) or 1) > 1:
        raise NotImplementedError("optim.grad_accum_steps > 1 is not ported "
                                  "yet (ROADMAP queue 1 item 11)")
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
                     skip_nonfinite=cfg.optim.get("skip_nonfinite", 0) or 0)
