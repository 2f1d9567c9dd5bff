"""Training hooks: logging and checkpointing (port of
``simseg_tpu/core/train_hooks.py``: ``LogHook`` and ``CheckpointHook`` with
the native backend; the retrieval, preemption, profile and wandb hooks are
not ported yet).

Parity: LogHook, reference ``core/hooks/log.py:64-146`` — a train line per
interval with the step's metrics and step time; CheckpointHook,
``core/hooks/checkpoint.py:80-187`` — step-interval and per-epoch
checkpoints, auto-resume (mid-epoch included) and an external pretrained
init.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np

from simseg_tpu_torch.checkpoint.native import (dump_config_snapshot,
                                                has_checkpoint, load_checkpoint,
                                                load_params, save_checkpoint)
from simseg_tpu_torch.core.hooks import Hook

logger = logging.getLogger(__name__)


class LogHook(Hook):

    def __init__(self) -> None:
        self._t0 = time.time()
        self._step_times: List[float] = []

    def before_run(self, runner) -> None:
        self._t0 = time.time()
        self._step_times = []

    def before_train_step(self, runner) -> None:
        self._t0 = time.time()

    def after_train_step(self, runner) -> None:
        self._step_times.append(time.time() - self._t0)
        interval = runner.cfg.log.interval_train
        if not self.every_n_inner_steps(runner, interval):
            return
        # the device metrics are read only at log cadence (one sync)
        metrics = {}
        for k, v in sorted(runner.outputs.items()):
            try:
                metrics[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        rate = runner.state.log_metrics.pop_counter_rate("samples")
        kv = " ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
        logger.info(
            f"Epoch [{runner.epoch + 1}/{runner.max_epochs}]"
            f"[{runner.inner_step + 1}/{runner.train_steps}] {kv} "
            f"step_time: {np.mean(self._step_times[-interval:]):.3f}s "
            f"({rate:.1f} img/s)")

    def after_train_epoch(self, runner) -> None:
        if self._step_times:
            logger.info(f"Epoch {runner.epoch + 1} done: avg step time "
                        f"{np.mean(self._step_times):.3f}s over "
                        f"{len(self._step_times)} steps")
        self._step_times = []


class CheckpointHook(Hook):
    """Native checkpoints under ``cfg.ckpt.dir``: every
    ``ckpt.step_interval`` steps as ``ckpt.filename``, and at each epoch's
    end as ``epoch_NNN``; resumed from ``latest_ckpt`` before the run."""

    def before_run(self, runner) -> None:
        cfg = runner.cfg
        dump_config_snapshot(cfg.ckpt.dir, cfg)
        if cfg.ckpt.auto_resume and has_checkpoint(cfg.ckpt.dir):
            try:
                meta = load_checkpoint(cfg.ckpt.dir, runner.model,
                                       runner.optimizer)
                runner.epoch = int(meta.get("epoch", 0))
                runner.step = int(meta.get("step", 0))
                runner.inner_step = int(meta.get("inner_step", 0))
                logger.info(f"Auto-resumed at epoch {runner.epoch}, step "
                            f"{runner.step}")
                return
            except Exception:  # parity: the reference's fallback
                logger.warning("Auto-resume failed; trying external",
                               exc_info=True)
        if cfg.ckpt.external_resume:
            self._load_external(runner, cfg.ckpt.external_resume)

    def _load_external(self, runner, path: str) -> None:
        """A reference ``.pth`` or a native checkpoint as pretrained init:
        parameters only, no optimizer state or step."""
        cfg = runner.cfg
        if path.endswith((".pth", ".pt")):
            from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint

            load_clip_checkpoint(
                path, runner.model,
                prefix_rules=list(cfg.model.get("pretrain_prefix_change_list", [])),
                only_image_encoder=cfg.ckpt.get("only_load_image_encoder", False),
                only_text_encoder=cfg.ckpt.get("only_load_text_encoder", False),
                strict=not cfg.ckpt.get("soft_resume", False))
        else:
            load_params(path, runner.model)
        logger.info(f"Loaded external checkpoint {path}")

    def _meta(self, runner) -> Dict[str, Any]:
        return {"epoch": runner.epoch, "step": runner.step,
                "inner_step": runner.inner_step + 1}

    def _save(self, runner, name: str, meta) -> None:
        save_checkpoint(runner.cfg.ckpt.dir, name, runner.model,
                        runner.optimizer, meta)

    def after_train_step(self, runner) -> None:
        interval = runner.cfg.ckpt.step_interval
        if interval > 0 and self.every_n_steps(runner, interval):
            self._save(runner, runner.cfg.ckpt.filename, self._meta(runner))

    def after_train_epoch(self, runner) -> None:
        meta = self._meta(runner)
        meta["epoch"] = runner.epoch + 1
        meta["inner_step"] = 0
        self._save(runner, f"epoch_{runner.epoch + 1:03d}", meta)
