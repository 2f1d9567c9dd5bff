"""Training hooks: logging, checkpointing, preemption, retrieval
validation, profiling and wandb (port of ``simseg_tpu/core/train_hooks.py``:
``LogHook``, ``CheckpointHook`` with the native backend, ``PreemptionHook``,
``RetrievalEvalHook``, ``ProfileHook``, ``LinearEvalHook`` and
``WandbHook``; the orbax backend is not ported yet, ROADMAP queue 1 item
11).

Parity: LogHook, reference ``core/hooks/log.py:64-146`` — a train line per
interval with the step's metrics and step time, validation progress;
CheckpointHook, ``core/hooks/checkpoint.py:80-187`` — step-interval and
per-epoch checkpoints, auto-resume (mid-epoch included) and an external
pretrained init; PreemptionHook, JAX ``train_hooks.py:237-278`` (beyond
the reference); RetrievalEvalHook, ``tasks/clip/hooks/eval.py:9-99`` —
the validation embeddings collected, R@1/5/10 and RSUM at the end;
LinearEvalHook, ``tasks/linear_prob/hooks/eval.py:9-54`` — top-1 / top-5;
ProfileHook (JAX :342-370, beyond the reference) — ``torch.profiler`` over
a window of steps; WandbHook (JAX :403-446) — the run's metrics to wandb,
its id kept in the checkpoint meta so that a resumed run continues it.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from simseg_tpu_torch.checkpoint.native import (dump_config_snapshot,
                                                has_checkpoint, load_checkpoint,
                                                load_params, save_checkpoint)
from simseg_tpu_torch.core.hooks import Hook
from simseg_tpu_torch.parallel.collectives import (all_reduce_max,
                                                   allgather_rows,
                                                   process_allgather)
from simseg_tpu_torch.parallel.mesh import host_group, is_distributed
from simseg_tpu_torch.utils.retrieval import retrieval_summary

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
        # for the same cadence's consumers (WandbHook): one read a log step
        runner.state.logged_metrics = (runner.step, metrics)
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

    def after_val_epoch(self, runner) -> None:
        """Restart the throughput window, so that the next train rate does
        not count validation time."""
        runner.state.log_metrics.pop_counter_rate("samples")

    def after_val_step(self, runner) -> None:
        """Validation progress (parity: log.py:111-123)."""
        interval = runner.cfg.log.get("interval_val", 1)
        i = runner.state.get("val_inner_step", 0)
        if interval > 0 and (i + 1) % max(interval, 1) == 0:
            logger.info(f"Val [{runner.state.get('val_loader_idx', 0)}]"
                        f"[{i + 1}/{runner.state.get('val_steps', '?')}]")


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
                runner.state.wandb_id = meta.get("wandb_id")
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
                "inner_step": runner.inner_step + 1,
                "wandb_id": runner.state.get("wandb_id")}

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


class PreemptionHook(Hook):
    """Graceful preemption (JAX ``PreemptionHook``): on SIGTERM, finish the
    step, write the step checkpoint through the registered
    ``CheckpointHook`` and exit 0, so that a restarted job auto-resumes in
    the middle of its epoch. A second SIGTERM takes the default action.
    A run that ends puts the handler it found back, so that a process which
    goes on after ``train`` returns is stopped by SIGTERM as before.

    In a world the ranks agree on the step to stop at: after every step the
    flag goes through a max all-reduce on the host group, so all ranks stop
    after the first step at whose end any rank holds it (a rank that
    stopped alone would hang the others at their next collective)."""

    def before_run(self, runner) -> None:
        import signal

        self._requested = False

        def _handler(signum, frame):
            self._requested = True
            signal.signal(signal.SIGTERM, self._orig)
            logger.warning("SIGTERM received: checkpointing after the current "
                           "step, then exiting 0 for auto-resume")

        self._handler = _handler
        self._orig = signal.signal(signal.SIGTERM, _handler)

    def after_run(self, runner) -> None:
        import signal

        if signal.getsignal(signal.SIGTERM) is self._handler:
            signal.signal(signal.SIGTERM, self._orig)

    def _agreed(self) -> bool:
        if not is_distributed():
            return self._requested
        flag = torch.tensor([float(self._requested)])
        return bool(all_reduce_max(flag, host_group()).item())

    def after_train_step(self, runner) -> None:
        if not self._agreed():
            return
        saved = False
        for hook in runner._hooks:
            if isinstance(hook, CheckpointHook):
                hook._save(runner, runner.cfg.ckpt.filename, hook._meta(runner))
                saved = True
        status = "written" if saved else "SKIPPED (no CheckpointHook)"
        logger.warning(f"Preemption checkpoint {status} at epoch "
                       f"{runner.epoch}, step {runner.step}: exiting")
        raise SystemExit(0)


class RetrievalEvalHook(Hook):
    """Collects each validation step's embeddings (on the device) and ids;
    at the end of the pass, R@1/5/10 and RSUM over the rows whose image id
    is not -1 (padding, eval.py:32-33), kept in
    ``runner.state.retrieval_summary``. In a world where
    ``data.single_eval`` is false each rank embedded its shard of the valid
    set: the embeddings and ids are gathered from every rank first (JAX
    ``train_hooks.py:326-334``, the reference's all_gather), the shorter
    shards padded with id -1. The ranks of a model group (``dist.tp_size``)
    embed the same shard together; only the group's first rank's rows are
    kept."""

    def before_val_epoch(self, runner) -> None:
        self._img, self._txt, self._iid, self._cid = [], [], [], []

    def after_val_step(self, runner) -> None:
        out = runner.outputs
        self._img.append(out["image_emb"])
        self._txt.append(out["text_emb"])
        if out.get("image_id") is not None:
            self._iid.append(np.asarray(out["image_id"]))
            self._cid.append(np.asarray(out["caption_id"]))

    def after_val_epoch(self, runner) -> None:
        img = torch.cat(self._img)
        txt = torch.cat(self._txt)
        if self._iid:
            iid = np.concatenate(self._iid)
            cid = np.concatenate(self._cid)
        else:
            iid = np.arange(img.shape[0])
            cid = np.arange(txt.shape[0])
        if is_distributed() and not runner.cfg.data.get("single_eval", True):
            dev = img.device
            mesh = getattr(runner, "mesh", None)
            if mesh is not None and mesh.holds_copy:
                # the model group's first rank (stage 0) holds the same rows
                iid = np.full_like(iid, -1)
            img, txt, iid, cid = allgather_rows(
                [img.cpu().numpy(), txt.cpu().numpy(), iid, cid],
                [0.0, 0.0, -1, -1])
            img, txt = torch.from_numpy(img).to(dev), torch.from_numpy(txt).to(dev)
        keep = iid > -1
        rows = torch.from_numpy(np.flatnonzero(keep)).to(img.device)
        summary = retrieval_summary(img[rows], txt[rows], iid[keep], cid[keep])
        runner.state.retrieval_summary = summary
        pretty = " ".join(f"{k}: {v:.4f}" for k, v in summary.items())
        logger.info(f"[retrieval val #{runner.state.get('val_loader_idx', 0)}] "
                    f"{pretty}")


class LinearEvalHook(Hook):
    """Collects each validation step's logits and labels; at the end of the
    pass, top-1 and top-5 accuracy from ``np.argsort(-logits)``'s first
    five columns (JAX ``LinearEvalHook``, ``simseg_tpu/core/train_hooks.py:
    374-400``), kept in ``runner.state.linear_eval``. In a world where
    ``data.single_eval`` is false each rank scored its (padded, equal)
    shard: every rank's rows are gathered first."""

    def before_val_epoch(self, runner) -> None:
        self._logits, self._labels = [], []

    def after_val_step(self, runner) -> None:
        self._logits.append(runner.outputs["logits"].float().cpu().numpy())
        self._labels.append(np.asarray(runner.outputs["label"]))

    def after_val_epoch(self, runner) -> None:
        logits = np.concatenate(self._logits)
        labels = np.concatenate(self._labels)
        if is_distributed() and not runner.cfg.data.get("single_eval", True):
            logits = process_allgather(logits).reshape(-1, logits.shape[-1])
            labels = process_allgather(labels).reshape(-1)
        top5 = np.argsort(-logits, axis=1)[:, :5]
        acc1 = float(np.mean(top5[:, 0] == labels))
        acc5 = float(np.mean(np.any(top5 == labels[:, None], axis=1)))
        runner.state.linear_eval = {"acc1": acc1, "acc5": acc5}
        logger.info(f"[linear eval] top-1: {acc1:.4f} top-5: {acc5:.4f}")


class ProfileHook(Hook):
    """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity)
    over steps [start_step, start_step + num_steps), configured as JAX's:
    ``cfg.profile = {start_step: 10, num_steps: 5, dir: <ckpt.dir>/trace}``.
    The device is synchronised before the profiler stops; the trace goes to
    ``<dir>/trace_<first>-<last>.json`` (Chrome trace format; over ranks
    ``trace_<first>-<last>.rank<r>.json``), its path to
    ``runner.state.profile_trace`` and the profiler to ``self.profiler``
    (``key_averages()``)."""

    def __init__(self) -> None:
        self.profiler = None
        self._stop_at = 0
        self._first = 0

    def before_train_step(self, runner) -> None:
        prof = runner.cfg.get("profile", {}) or {}
        if not prof or self.profiler is not None:
            return
        if runner.step == prof.get("start_step", 10):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if runner.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._dir = prof.get("dir", os.path.join(runner.cfg.ckpt.dir, "trace"))
            self._first = runner.step
            self._stop_at = runner.step + prof.get("num_steps", 5)
            self.profiler = profile(activities=activities)
            self.profiler.start()
            logger.info(f"Profiler trace started -> {self._dir}")

    def after_train_step(self, runner) -> None:
        if self.profiler is not None and runner.step >= self._stop_at:
            self._stop(runner)

    def after_run(self, runner) -> None:
        if self.profiler is not None and not runner.state.get("profile_trace"):
            self._stop(runner)   # the run ended inside the window

    def _stop(self, runner) -> None:
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        self.profiler.stop()
        os.makedirs(self._dir, exist_ok=True)
        rank = (f".rank{torch.distributed.get_rank()}"
                if torch.distributed.is_initialized() else "")
        path = os.path.join(
            self._dir, f"trace_{self._first}-{runner.step - 1}{rank}.json")
        self.profiler.export_chrome_trace(path)
        runner.state.profile_trace = path
        self._stop_at = float("inf")   # one window a run, as JAX's
        logger.info(f"Profiler trace stopped -> {path}")


class WandbHook(Hook):
    """The run's metrics to wandb (JAX ``WandbHook``): ``wandb.init`` with
    ``wandb.project`` / ``entity``, the id from the checkpoint meta (a
    resumed run continues its wandb run) and the config; the
    ``wandb.train_record_keys`` of a step every ``log.interval_train``
    (``LogHook``'s read reused), the retrieval summary after validation,
    ``finish`` at the end. Without wandb installed it warns and does
    nothing."""

    def before_run(self, runner) -> None:
        try:
            import wandb
        except ImportError:
            logger.warning("wandb not installed; WandbHook disabled")
            self._run = None
            return
        cfg = runner.cfg
        self._run = wandb.init(project=cfg.wandb.project,
                               entity=cfg.wandb.entity,
                               id=runner.state.get("wandb_id"),
                               resume="allow", config=cfg.to_dict())
        runner.state.wandb_id = self._run.id

    def after_train_step(self, runner) -> None:
        if getattr(self, "_run", None) is None:
            return
        if not self.every_n_inner_steps(runner, runner.cfg.log.interval_train):
            return
        keys = runner.cfg.wandb.train_record_keys
        stashed = runner.state.get("logged_metrics")
        if stashed and stashed[0] == runner.step:
            pulled = stashed[1]
        else:
            pulled = {k: v for k, v in runner.outputs.items() if k in keys}
        self._run.log({k: float(v) for k, v in pulled.items() if k in keys},
                      step=runner.step)

    def after_val_epoch(self, runner) -> None:
        if getattr(self, "_run", None) is None:
            return
        if runner.state.get("retrieval_summary"):
            self._run.log(dict(runner.state.retrieval_summary), step=runner.step)

    def after_run(self, runner) -> None:
        if getattr(self, "_run", None) is not None:
            self._run.finish()

