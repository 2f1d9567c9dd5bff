"""Training runners: host-side epoch/step loops driving the train step
(port of ``simseg_tpu/core/runner.py``: ``EpochRunner`` and ``CLIPRunner``).

Parity: reference ``simseg/core/runners/base_runner.py:20-86`` (hook
registry and fan-out), ``epoch_runner.py:15-178`` (epoch/step loops, steps
math, mid-epoch resume) and ``tasks/clip/clip_runner.py:19-299`` (hook
wiring, batch_processor). The runner owns the model (moved to its device),
the optimizer and the lr schedule; the train loaders are any iterables of
batch dicts with ``image`` (uint8 or float NHWC), ``input_ids`` and
``attention_mask`` (or ``caption`` strings, tokenized here), optionally
``ignore_mask``.

Not ported yet: validation during training (retrieval eval, ROADMAP queue 1
item 9), the BSGS runner (item 12), the linear-probe runner (item 14) and
device prefetch.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.core.hooks import Hook, HookMode, LogMetrics, Priority
from simseg_tpu_torch.core.lr_schedule import build_schedule
from simseg_tpu_torch.core.optim import build_optimizer
from simseg_tpu_torch.data.transforms import normalize_images
from simseg_tpu_torch.engine.train_step import make_train_step
from simseg_tpu_torch.utils.collections import AttrDict

_BATCH_KEYS = ("image", "input_ids", "attention_mask", "ignore_mask")


class BaseRunner:
    """Hook registry + fan-out (parity: base_runner.py:20-86)."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.state = AttrDict()  # hook scratch space
        self.state.log_metrics = LogMetrics()
        self._hooks: List[Hook] = []
        self.inference = bool(cfg.get("inference", False))

    def register_hook(self, hook: Hook, priority: Priority = Priority.NORMAL,
                      hook_mode: HookMode = HookMode.GLOBAL) -> None:
        if self.inference and hook_mode == HookMode.TRAIN:
            return
        if not self.inference and hook_mode == HookMode.VAL:
            return
        hook._priority = int(priority)
        self._hooks.append(hook)
        self._hooks.sort(key=lambda h: h._priority)

    def call_hook(self, fn_name: str) -> None:
        for hook in self._hooks:
            getattr(hook, fn_name)(self)


class EpochRunner(BaseRunner):
    """Epoch/step loops with hook callbacks (parity: epoch_runner.py)."""

    def __init__(self, cfg, model: torch.nn.Module, dataloaders: Dict[str, Any],
                 device=None, tokenizer=None) -> None:
        super().__init__(cfg)
        if dataloaders.get("val"):
            raise NotImplementedError("validation during training (retrieval "
                                      "eval) is not ported yet (ROADMAP queue "
                                      "1 item 9)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.train_loaders: Sequence = dataloaders.get("train") or []
        self.train_type = cfg.data.get("train_type", "shuffle")

        self.epoch = 0
        self.step = 0
        self.inner_step = 0
        self.max_epochs = cfg.epoch

        # steps math (parity: epoch_runner.py:39-65); a loader without a
        # length needs data.train_steps
        self.train_steps = (cfg.data.train_steps if cfg.data.train_steps > 0
                            else sum(len(l) for l in self.train_loaders))
        self.total_steps = max(self.train_steps * self.max_epochs, 1)

        self.optimizer = build_optimizer(cfg, self.model,
                                         frozen_patterns=self.frozen_patterns())
        self.lr_schedule = build_schedule(cfg, self.total_steps)
        self._norm_mean = tuple(cfg.transforms.normalize.mean)
        self._norm_std = tuple(cfg.transforms.normalize.std)
        self.outputs: Dict[str, Any] = {}
        self.build_step_fns()
        self.init_hook()
        self.call_hook("init_runner")

    # -- subclass API ------------------------------------------------------------
    def frozen_patterns(self):
        """Regexes of JAX parameter paths excluded from optimization."""
        return ()

    def build_step_fns(self) -> None:
        raise NotImplementedError

    def batch_processor(self, batch) -> Dict[str, Any]:
        raise NotImplementedError

    def init_hook(self) -> None:
        from simseg_tpu_torch.core.train_hooks import CheckpointHook, LogHook

        self.register_hook(CheckpointHook(), Priority.LOW)
        self.register_hook(LogHook(), Priority.VERY_LOW)

    # -- shared plumbing ------------------------------------------------------------
    def _prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's tensors on the device: captions tokenized when the
        batch has no ``input_ids``, uint8 images normalised there."""
        batch = dict(batch)
        if "input_ids" not in batch and "caption" in batch:
            if self.tokenizer is None:
                raise ValueError("a batch of captions needs a tokenizer")
            tok = self.tokenizer(list(batch["caption"]),
                                 max_length=self.cfg.model.max_length)
            batch["input_ids"] = tok["input_ids"]
            batch["attention_mask"] = tok["attention_mask"]
        out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
               .to(self.device, non_blocking=True)
               for k, v in batch.items() if k in _BATCH_KEYS}
        if out["image"].dtype == torch.uint8:
            out["image"] = normalize_images(out["image"], self._norm_mean,
                                            self._norm_std)
        for k in ("input_ids", "attention_mask"):
            if k in out:
                out[k] = out[k].long()
        return out

    def _train_batch_iter(self):
        for loader in self.train_loaders:
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(self.epoch)
        if self.train_type == "shuffle":
            return iter(self.train_loaders[0])
        if self.train_type == "sequential":
            return itertools.chain.from_iterable(self.train_loaders)
        # 'debias' samples loaders by their sizes: with the dataset loader
        # (ROADMAP queue 1 item 10)
        raise NotImplementedError(f"data.train_type '{self.train_type}'")

    # -- loops -------------------------------------------------------------------
    def run(self) -> None:
        self.call_hook("before_run")
        while self.epoch < self.max_epochs:
            self.train()
            self.epoch += 1
        self.call_hook("after_run")

    def train(self) -> None:
        self.model.train()
        self.call_hook("_before_train_epoch")
        start_inner = self.inner_step  # mid-epoch resume (clip_runner.py:267-278)
        self.inner_step = 0
        for i, batch in enumerate(self._train_batch_iter()):
            if i >= self.train_steps:
                # exactly train_steps steps when data.train_steps caps a
                # longer loader (parity: epoch_runner.py:77-108)
                break
            if i < start_inner:
                continue
            self.inner_step = i
            self.call_hook("_before_train_step")
            self.outputs = self.batch_processor(batch)
            # count before the after-step hooks, so that a checkpoint records
            # the completed steps (parity: core/hooks/checkpoint.py:26)
            self.step += 1
            self.call_hook("_after_train_step")
        self.inner_step = 0
        self.call_hook("_after_train_epoch")


class CLIPRunner(EpochRunner):
    """Contrastive pretraining runner (parity: clip_runner.py)."""

    def frozen_patterns(self):
        """parity: pipelines/clip.py:199-200/217-218 + projection trainable
        flags (components/projection.py:41-43)."""
        m = self.cfg.model
        patterns = []
        if not m.image_encoder.get("trainable", True):
            patterns.append(r"^params/image_encoder/")
        if not m.text_encoder.get("trainable", True):
            patterns.append(r"^params/text_encoder/")
        proj = m.get("projection", {})
        if not proj.get("image_projector_trainable", True):
            patterns.append(r"^params/image_projection/")
        if not proj.get("text_projector_trainable", True):
            patterns.append(r"^params/text_projection/")
        return tuple(patterns)

    def build_step_fns(self) -> None:
        cfg = self.cfg
        if cfg.runner.name != "clip":
            raise NotImplementedError(f"runner '{cfg.runner.name}' is not "
                                      "ported yet (BSGS: ROADMAP queue 1 item 12)")
        for enc in ("image_encoder", "text_encoder"):
            arch = dict(cfg.model[enc].get("arch", {}) or {})
            if arch.get("quant", "none") not in (None, "", "none"):
                raise NotImplementedError(f"{enc} arch quant is inference-only")
        group_size = int(cfg.loss.get("group_size", -1))
        if group_size > 1:
            # devices per group in the JAX package; one card is one group
            raise NotImplementedError("loss.group_size > 1 needs several "
                                      "cards (ROADMAP queue 1 item 13)")
        self._step_fn = make_train_step(
            self.model, self.optimizer,
            smoothing=cfg.loss.get("smoothing", 0.0),
            loss_name=cfg.loss.get("name", "NCE"),
            mixup_alpha_param=cfg.get("mixup", {}).get("alpha", 0.2),
            triplet_margin=cfg.loss.get("triplet_loss", {}).get("margin", 0.2),
            triplet_reduce=cfg.loss.get("triplet_loss", {}).get("reduce_mode", "max"),
            extra_losses=tuple(cfg.loss.get("extra_losses", []) or ()),
            seed=int(cfg.seed or 0),
        )

    def batch_processor(self, batch) -> Dict[str, Any]:
        """One train step (parity: clip_runner.py:216-251); the metrics stay
        on the device until a hook reads them."""
        device_batch = self._prepare_batch(batch)
        lr = self.lr_schedule(self.step)
        deterministic = self.cfg.runner.get("stable_random", "none") == "none"
        metrics = self._step_fn(device_batch, lr, self.step, deterministic)
        self.state.log_metrics.add_counter("samples",
                                           device_batch["image"].shape[0])
        return metrics
