"""Stateless step-indexed learning-rate schedules (port of
``simseg_tpu/core/lr_schedule.py``).

Parity: reference ``simseg/core/optimizer/lr_scheduler.py:87-222`` — the same
six schedules, as plain ``step -> lr`` functions of the global step that the
runner evaluates on the host and writes into the optimizer's groups before
every step (``core/optim.py:Optimizer.set_lr``).
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Sequence

from simseg_tpu_torch.utils.registry import Registry

Schedule = Callable[[int], float]

# name -> schedule factory (the JAX package's ``LR`` registry)
LR = Registry("LR")


def _warmup(step: float, num_warmup_steps: int) -> float:
    return float(step) / float(max(1.0, num_warmup_steps))


@LR.register
def constant_schedule(init_lr: float, **_) -> Schedule:
    return lambda step: init_lr


@LR.register
def constant_schedule_with_warmup(init_lr: float, num_warmup_steps: int, **_) -> Schedule:
    def fn(step):
        if step < num_warmup_steps:
            return init_lr * _warmup(step, num_warmup_steps)
        return init_lr
    return fn


@LR.register
def linear_schedule_with_warmup(
    init_lr: float, num_warmup_steps: int, num_training_steps: int, **_
) -> Schedule:
    def fn(step):
        if step < num_warmup_steps:
            return init_lr * _warmup(step, num_warmup_steps)
        return init_lr * max(
            0.0,
            float(num_training_steps - step)
            / float(max(1, num_training_steps - num_warmup_steps)),
        )
    return fn


@LR.register
def multi_step_schedule_with_warmup(
    init_lr: float, num_warmup_steps: int, milestone_steps: Sequence[int],
    gamma: float = 0.1, **_
) -> Schedule:
    milestones = sorted(milestone_steps)

    def fn(step):
        if step < num_warmup_steps:
            return init_lr * _warmup(step, num_warmup_steps)
        return init_lr * gamma ** bisect_right(milestones, step)
    return fn


@LR.register
def cosine_schedule_with_warmup(
    init_lr: float, num_warmup_steps: int, num_training_steps: int,
    num_cycles: float = 0.5, **_
) -> Schedule:
    def fn(step):
        if step < num_warmup_steps:
            return init_lr * _warmup(step, num_warmup_steps)
        progress = float(step - num_warmup_steps) / float(
            max(1, num_training_steps - num_warmup_steps)
        )
        return init_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        )
    return fn


@LR.register
def cosine_schedule_with_warmup_min_lr_scale(
    init_lr: float, num_warmup_steps: int, num_training_steps: int,
    num_cycles: float = 0.5, min_lr_scale: float = 0.01, **_
) -> Schedule:
    assert 0 <= min_lr_scale <= 1.0

    def fn(step):
        if step < num_warmup_steps:
            return init_lr * _warmup(step, num_warmup_steps)
        progress = float(step - num_warmup_steps) / float(
            max(1, num_training_steps - num_warmup_steps)
        )
        scale = min_lr_scale + (1.0 - min_lr_scale) * 0.5 * (
            1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)
        )
        return init_lr * max(0.0, scale)
    return fn


def build_schedule(cfg, total_steps: int) -> Schedule:
    """Build from ``cfg.optim.lr`` (parity: core/hooks/optimizer.py:120-154:
    warmup = warmup_proportion * total steps)."""
    lr_cfg = cfg.optim.lr
    warmup = int(lr_cfg.warmup_proportion * total_steps)
    params = dict(lr_cfg.get("param", {}))
    return LR.get(lr_cfg.name)(
        init_lr=lr_cfg.init,
        num_warmup_steps=warmup,
        num_training_steps=total_steps,
        **params,
    )
