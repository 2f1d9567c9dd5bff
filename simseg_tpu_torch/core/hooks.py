"""Hook system: lifecycle callbacks around the training loop (port of
``simseg_tpu/core/hooks.py``, a copy).

Parity: reference ``simseg/core/hooks/hook.py:1-93`` (16 no-op callbacks,
``_``-prefixed combinators calling generic-then-specific, every_n helpers)
and ``core/hooks/utils.py:12-94`` (Priority, HookMode). The runner calls
hooks on the host around the device step.
"""

from __future__ import annotations

import enum
import time
from typing import Dict


class Priority(enum.IntEnum):
    HIGHEST = 0
    VERY_HIGH = 10
    HIGH = 30
    NORMAL = 50
    LOW = 70
    VERY_LOW = 90
    LOWEST = 100


class HookMode(enum.Enum):
    GLOBAL = "global"
    TRAIN = "train"
    VAL = "val"


class Hook:
    """16 lifecycle callbacks, all optional."""

    def init_runner(self, runner) -> None: ...
    def before_run(self, runner) -> None: ...
    def after_run(self, runner) -> None: ...

    def before_epoch(self, runner) -> None: ...
    def after_epoch(self, runner) -> None: ...
    def before_train_epoch(self, runner) -> None: ...
    def after_train_epoch(self, runner) -> None: ...
    def before_val_epoch(self, runner) -> None: ...
    def after_val_epoch(self, runner) -> None: ...

    def before_step(self, runner) -> None: ...
    def after_step(self, runner) -> None: ...
    def before_train_step(self, runner) -> None: ...
    def after_train_step(self, runner) -> None: ...
    def before_val_step(self, runner) -> None: ...
    def after_val_step(self, runner) -> None: ...

    # combinators (parity: hook.py:51-81)
    def _before_train_epoch(self, runner) -> None:
        self.before_epoch(runner)
        self.before_train_epoch(runner)

    def _after_train_epoch(self, runner) -> None:
        self.after_epoch(runner)
        self.after_train_epoch(runner)

    def _before_val_epoch(self, runner) -> None:
        self.before_epoch(runner)
        self.before_val_epoch(runner)

    def _after_val_epoch(self, runner) -> None:
        self.after_epoch(runner)
        self.after_val_epoch(runner)

    def _before_train_step(self, runner) -> None:
        self.before_step(runner)
        self.before_train_step(runner)

    def _after_train_step(self, runner) -> None:
        self.after_step(runner)
        self.after_train_step(runner)

    def _before_val_step(self, runner) -> None:
        self.before_step(runner)
        self.before_val_step(runner)

    def _after_val_step(self, runner) -> None:
        self.after_step(runner)
        self.after_val_step(runner)

    @staticmethod
    def every_n_epochs(runner, n: int) -> bool:
        return (runner.epoch + 1) % n == 0 if n > 0 else False

    @staticmethod
    def every_n_steps(runner, n: int) -> bool:
        # runner.step is incremented before after-step hooks fire, so it is
        # the count of completed steps at hook time
        return runner.step % n == 0 if n > 0 else False

    @staticmethod
    def every_n_inner_steps(runner, n: int) -> bool:
        return (runner.inner_step + 1) % n == 0 if n > 0 else False


class LogMetrics:
    """Windowed rate counters (parity: core/hooks/log.py:24-62's throughput
    meters). Scalar metrics are NOT accumulated here: the reference's
    AverageMeter interval means would require materializing every step's
    device outputs, so LogHook prints the log-cadence instantaneous values
    instead and stashes the one materialized dict on runner.state."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._counter_t0: Dict[str, float] = {}

    def add_counter(self, key: str, value: float = 1.0) -> None:
        if key not in self._counters:
            self._counters[key] = 0.0
            self._counter_t0[key] = time.time()
        self._counters[key] += value

    def pop_counter_rate(self, key: str) -> float:
        dt = max(time.time() - self._counter_t0.get(key, time.time()), 1e-9)
        rate = self._counters.get(key, 0.0) / dt
        self._counters[key] = 0.0
        self._counter_t0[key] = time.time()
        return rate
