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

Sharded state (``parallel/sharding.py``): a parameter that TP or FSDP
shards is a shard here too, and so are its moments. Under ZeRO-1
(``dist.zero1``) the optimizer steps a view of its data rank's slice of
each parameter it shards (``ParamSpec.zero_dim``), so the moments exist for
that slice only: the whole gradient, summed over the data ranks, is viewed
in the same slice, the slice updated in place and the other ranks' slices
all-gathered into the parameter. AdamW,
Adam and SGD are elementwise, so the parameters are bit for bit the
data-parallel step's. Where some gradient is a shard, the global norm
counts each element once over the world (``sharding.grad_sq_norm``) and
the non-finite guard decides on every rank's gradients, so clipping and
the guard see the whole gradient and every rank decides the same.
``state_dict`` gathers the moments whole (a collective: every rank calls
it; ``keep`` False drops each as it is gathered, on a rank that does not
write), the state a data-parallel run writes, and ``load_state_dict`` cuts a
whole state to this rank's slices. LARS's per-tensor trust ratios take the
whole tensors' norms: each rank's part (shard or slice) adds its squares,
counted once over the world, to one sum over the ranks (``LARS``), so a
sharded leg updates each part as one process updates the whole tensor.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from simseg_tpu_torch.checkpoint.convert import flax_param_path
from simseg_tpu_torch.parallel.collectives import all_reduce_max, all_reduce_sum
from simseg_tpu_torch.parallel.mesh import host_group
from simseg_tpu_torch.parallel.sharding import (gather_zero_slices, grad_sq_norm,
                                                plan_of)

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
    is not SGD-style LARS, whose trace holds lr-free updates.

    On a sharded leg a tensor here may be a shard (TP, FSDP) or a ZeRO-1
    slice. ``shard_sum`` (set by ``Optimizer``: a sum over the world) and
    ``counted`` (per tensor, in the groups' order: whether this rank's part
    counts, each element of the whole tensor once over the world) make the
    norms of step 2 the whole tensors': |p|^2 and |u|^2 of each part, summed
    over the ranks in one reduction, then the root, so that every rank
    scales its part by the ratio one process computes from the whole."""

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001
                 ) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))
        self.shard_sum = None
        self.counted: Optional[List[bool]] = None

    @staticmethod
    def _decayed(group, p) -> torch.Tensor:
        u = p.grad.float()
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p.float()
        return u

    def _whole_norms(self, items) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(|p|, |u|) of each (index, group, p) of ``items`` over the whole
        tensors: the counted parts' squares summed over the world."""
        device = items[0][2].device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        sq = []
        for i, group, p in items:
            if self.counted[i]:
                sq.append(torch.stack([
                    torch.linalg.vector_norm(p.float()) ** 2,
                    torch.linalg.vector_norm(self._decayed(group, p)) ** 2]))
            else:
                sq.append(torch.stack([zero, zero]))
        return list(torch.sqrt(self.shard_sum(torch.stack(sq))).unbind(0))

    @torch.no_grad()
    def step(self, closure=None):
        items = [(i, group, p) for i, (group, p) in enumerate(
            (g, p) for g in self.param_groups for p in g["params"])
            if p.grad is not None]
        if not items:
            return
        norms = self._whole_norms(items) if self.counted is not None else None
        for k, (_, group, p) in enumerate(items):
            u = self._decayed(group, p)
            if norms is None:
                p_norm = torch.linalg.vector_norm(p.float())
                u_norm = torch.linalg.vector_norm(u)
            else:
                p_norm, u_norm = norms[k]
            ratio = group["trust_coefficient"] * p_norm / u_norm
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(ratio), ratio)
            u = -group["lr"] * (u * ratio)
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
                 skip_nonfinite: int = 0, accum_steps: int = 1,
                 plan=None, zero: Sequence[tuple] = ()) -> None:
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.base = base
        self.max_norm = max_norm
        self.skip_nonfinite = skip_nonfinite
        self.notfinite_count = 0
        self.accum_steps = accum_steps
        self.mini_step = 0
        # the running mean of the steps' gradients (accum_steps > 1)
        self.acc: Optional[List[torch.Tensor]] = None
        # the shard plan (parallel/sharding.py; None: every parameter whole)
        self.plan = plan
        self.specs = [None if plan is None else plan.specs.get(n)
                      for n, _ in named]
        self._sharded = plan is not None and plan.sharded_grads
        # ZeRO-1: (parameter, the base optimizer's view of its slice, spec)
        self._zero = list(zero)
        # the spec of each base parameter, in the base state's index order,
        # and whether it is a ZeRO-1 slice
        of = {id(o): (spec, True) for _, o, spec in self._zero}
        of.update({id(p): (spec, False) for p, spec in zip(self.params,
                                                           self.specs)})
        self._base_specs = [of.get(id(t), (None, False))
                            for g in base.param_groups for t in g["params"]]
        name_of = {id(p): n for n, p in named}
        name_of.update({id(o): name_of[id(p)] for p, o, _ in self._zero})
        self._base_names = [name_of[id(t)] for g in base.param_groups
                            for t in g["params"]]
        if isinstance(base, LARS) and plan is not None and (
                self._sharded or self._zero):
            base.shard_sum = all_reduce_sum
            base.counted = [self.owns(spec, zero)
                            for spec, zero in self._base_specs]

    def base_entries(self):
        """(name, tensor, spec, zero) of each parameter the base optimizer
        steps, in its state's index order: ``tensor`` is the parameter, its
        shard, or with ``zero`` the view of its ZeRO-1 slice."""
        tensors = [t for g in self.base.param_groups for t in g["params"]]
        return [(n, t, spec, zero) for n, t, (spec, zero) in
                zip(self._base_names, tensors, self._base_specs)]

    def owns(self, spec, zero: bool = False) -> bool:
        """Whether this rank's part of a base parameter counts in a sum over
        the world that takes each element of the whole tensor once: a
        ZeRO-1 slice on every data rank of stage 0 and model index 0 (the
        slices differ by data rank and nothing else), else
        ``ShardPlan.owns``."""
        if zero:
            m = self.plan.mesh
            return m.stage == 0 and m.model_rank == 0
        return self.plan.owns(spec)

    def set_lr(self, lr: float) -> None:
        for group in self.base.param_groups:
            group["lr"] = lr * group["lr_mult"]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        for _, o, _ in self._zero:
            o.grad = None

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a missing grad is a
        zero), or under ``accum_steps`` one step of the accumulation;
        returns the global norm of this step's gradients before clipping,
        as a float32 scalar tensor, and clears the gradients."""
        norm = self._norm()
        if self.accum_steps == 1:
            self._update(norm)
        elif self._accumulate():
            self._update(self._norm())
        self.zero_grad()
        return norm

    def _norm(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        if self._sharded:
            return torch.sqrt(grad_sq_norm(grads, self.specs, self.plan))
        return _global_norm([g for g in grads if g is not None])

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
            if self._sharded:
                flag = torch.tensor([0.0 if finite else 1.0])
                finite = not bool(all_reduce_max(flag, host_group()).item())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            apply = finite or self.notfinite_count > self.skip_nonfinite
        if apply:
            if self.max_norm:
                scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                    self.max_norm / norm)
                torch._foreach_mul_(grads, scale)
            for p, o, spec in self._zero:
                # a view of the parameter's storage as it is now (``.to``
                # may have moved the parameter since the last step)
                o.data = self.plan.zero_view(p.detach(), spec)
                o.grad = (None if p.grad is None
                          else self.plan.zero_view(p.grad, spec))
            self.base.step()
            if self._zero:
                gather_zero_slices(self._zero, self.plan)

    def _moments(self, state: dict, whole: bool, keep: bool = True) -> dict:
        """The base optimizer's state with each moment whole (``whole``;
        ``keep`` False: each dropped once gathered) or cut to this rank's
        shard or slice."""
        plan = self.plan
        out = {}
        for i, st in state.items():
            spec, zero = self._base_specs[int(i)]
            new = {}
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0 and spec is not None:
                    if zero:
                        v = (plan.zero_full(v, spec) if whole
                             else plan.zero_local(v, spec))
                    elif spec.tp_dim is not None or spec.data_dim is not None:
                        v = plan.full(v, spec) if whole else plan.local(v, spec)
                if keep:
                    new[k] = v
            out[i] = new
        return out

    def _acc_layout(self, acc, whole: bool, keep: bool = True):
        if acc is None:
            return acc
        out = []
        for a, spec in zip(acc, self.specs):
            if self.plan is not None and spec is not None and (
                    spec.tp_dim is not None or spec.data_dim is not None):
                a = self.plan.full(a, spec) if whole else self.plan.local(a, spec)
            elif whole:
                a = a.clone()
            if keep:
                out.append(a)
        return out

    def state_dict(self, keep: bool = True) -> dict:
        """The state in the whole layout (a collective under a shard plan:
        every rank calls it). With ``keep`` False, on a rank that does not
        write it, each gathered tensor is dropped at once: that rank never
        holds the whole state, and what it returns is not a state."""
        base = self.base.state_dict()
        if self.plan is not None:
            base = dict(base, state=self._moments(base["state"], True, keep))
        state = {"base": base, "notfinite_count": self.notfinite_count}
        if self.accum_steps > 1:
            state["mini_step"] = self.mini_step
            state["acc"] = None if self.acc is None else self._acc_layout(
                self.acc, True, keep)
        return state

    def load_state_dict(self, state: dict) -> None:
        base = state["base"]
        if self.plan is not None:
            base = dict(base, state=self._moments(base["state"], False))
        self.base.load_state_dict(base)
        self.notfinite_count = int(state.get("notfinite_count", 0))
        self.mini_step = int(state.get("mini_step", 0))
        acc = self._acc_layout(state.get("acc"), False)
        self.acc = None if acc is None else [
            a.to(p.device, p.dtype).clone() for a, p in zip(acc, self.params)]

    def load_local_state(self, objects: dict, state: dict, acc) -> None:
        """A state in this rank's layout (the orbax backend's read,
        ``checkpoint/native.py``): ``state`` the base state's tensors by
        index, ``objects`` its param groups, non-tensor entries by
        parameter name and counters, ``acc`` the accumulation mean."""
        for i, name in enumerate(self._base_names):
            for k, v in objects["state"].get(name, {}).items():
                state.setdefault(i, {})[k] = v
        self.base.load_state_dict({"state": state,
                                   "param_groups": objects["param_groups"]})
        self.notfinite_count = int(objects["notfinite_count"])
        self.mini_step = int(objects["mini_step"])
        self.acc = acc if objects["acc"] else None


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
    plan = plan_of(model)
    by_label: Dict[str, List[torch.nn.Parameter]] = {}
    zero = []
    for name, p in named:
        label = param_label(flax_param_path(name), rules, frozen_patterns)
        spec = None if plan is None else plan.specs.get(name)
        if label != "_frozen" and spec is not None and spec.zero_dim is not None:
            # ZeRO-1: the base optimizer steps a view of this rank's slice
            o = torch.nn.Parameter(plan.zero_view(p.detach(), spec))
            zero.append((p, o, spec))
            p = o
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
                     accum_steps=int(cfg.optim.get("grad_accum_steps", 1) or 1),
                     plan=plan, zero=zero)
