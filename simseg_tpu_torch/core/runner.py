"""Training runners: host-side epoch/step loops driving the train step
(port of ``simseg_tpu/core/runner.py``: ``EpochRunner`` and ``CLIPRunner``).

Parity: reference ``simseg/core/runners/base_runner.py:20-86`` (hook
registry and fan-out), ``epoch_runner.py:15-178`` (epoch/step loops, steps
math, mid-epoch resume) and ``tasks/clip/clip_runner.py:19-299`` (hook
wiring, batch_processor) and ``tasks/linear_prob/linear_runner.py:20-200``
(``LinearProbRunner``). The runner owns the model (moved to its device),
the optimizer and the lr schedule; the train loaders are any iterables of
batch dicts with ``image`` (uint8 or float NHWC), ``input_ids`` and
``attention_mask`` (or ``caption`` strings, tokenized here), optionally
``ignore_mask``.

``runner.name`` is ``clip`` (``engine/train_step.py``) or ``clip_bsgs``
(``engine/bsgs.py``: the exact gradient of the ``data.batch_size`` batch in
micro-batches of ``data.batch_size_train``), refused where JAX refuses it.
A CNN image tower trains its BatchNorm live (batch statistics over the
global batch, running averages moved) unless ``model.freeze_cnn_bn``;
BSGS refuses live BN, as JAX does. ``LinearProbRunner`` trains the linear
probe (``models/linear_prob.py``) on ``label`` batches.

In a ``torch.distributed`` world (``parallel/mesh.py``) every rank runs
the runner on its shard of each batch (``data.batch_size`` is the global
batch, which the world size must divide, JAX ``runner.py:84-91``); the
steps gather the embeddings and sum the gradients over the ranks, so the
lr schedule, the steps and the parameters are the same on every rank.
``loss.group_size`` (ranks per gather group) must divide the world, as
JAX's ``make_mesh`` checks.

The sharded legs of ``dist`` (``tp_size``, ``sp``, ``fsdp``, ``zero1``;
JAX ``build_step_fns`` :342-445 and ``_adopt_step_factory``) are applied
to the model where the runner takes it (``prepare_model``:
``parallel/sharding.shard_model``) before the optimizer is built over its
shards; the steps then run them (``engine/``). ``dist.tp_size`` ranks form
a model group, which sees the same rows: the model group's first rank
broadcasts each host batch to the others, so their random augmentations
are one draw.

The MoE towers train with their aux (``loss.moe_aux_weight``) and
``dist.moe_ep`` splits their experts over the data ranks (``prepare_model``);
``dist.pp_size`` stages pipeline both towers' blocks
(``parallel/pp.make_pp_forward``, ``dist.pp_micro`` microbatches), their
ranks of one data index taking the batch of stage 0's rank, and compose
with data ranks, FSDP and ZeRO-1; the eval step runs the plain forward, as
JAX's ``make_eval_step`` does. JAX's refusals are kept: PP with tp or
gather groups (``make_mesh``), with MoE, ToMe, dropout or a CNN tower
(``make_pp_forward``), BSGS with PP or MoE.

``cfg.profile`` registers the ``ProfileHook`` and ``wandb.enable`` the
``WandbHook``, as JAX's runner does (``simseg_tpu/core/runner.py:171-174``).
``ckpt.backend`` picks the ``CheckpointHook``'s backend, msgpack or orbax
(``checkpoint/native.py``).
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.core.hooks import Hook, HookMode, LogMetrics, Priority
from simseg_tpu_torch.core.lr_schedule import build_schedule
from simseg_tpu_torch.core.optim import build_optimizer
from simseg_tpu_torch.data.datasets import debias_batches, sequential_batches
from simseg_tpu_torch.data.transforms import normalize_images
from simseg_tpu_torch.engine.bsgs import make_bsgs_train_step
from simseg_tpu_torch.engine.train_step import (make_eval_step, make_train_step,
                                                step_key)
from simseg_tpu_torch.models.layers import BatchNorm
from simseg_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                   broadcast_batch,
                                                   reduce_gradients)
from simseg_tpu_torch.parallel.sharding import shard_model
from simseg_tpu_torch.parallel.mesh import (batch_shards, loss_group_samples,
                                            make_mesh)
from simseg_tpu_torch.utils.collections import AttrDict

logger = logging.getLogger(__name__)

_BATCH_KEYS = ("image", "input_ids", "attention_mask", "ignore_mask", "label")


def refuse_bsgs_parallel(cfg) -> None:
    """JAX's refusal of BSGS with PP or MoE (``simseg_tpu/core/runner.py:
    367-380``), from the config alone, before the runner builds its mesh:
    PP's GPipe forward and the MoE aux objective do not fold into the
    two-pass analytic gradient."""
    image_arch = dict(cfg.model.image_encoder.get("arch", {}) or {})
    text_arch = dict(cfg.model.text_encoder.get("arch", {}) or {})
    if (int(cfg.dist.get("pp_size", 1) or 1) > 1
            or cfg.dist.get("moe_ep", False)
            or image_arch.get("moe_experts", 0)
            or text_arch.get("moe_experts", 0)):
        raise NotImplementedError(
            "runner 'clip_bsgs' does not combine with dist.pp_size>1 or "
            "MoE towers (use runner.name='clip')")


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
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.train_loaders: Sequence = dataloaders.get("train") or []
        self.val_loaders: Sequence = dataloaders.get("val") or []
        self.train_type = cfg.data.get("train_type", "shuffle")

        self.epoch = 0
        self.step = 0
        self.inner_step = 0
        self.max_epochs = cfg.epoch
        self.val_interval = cfg.runner.val_interval
        self.val_interval_steps = cfg.runner.val_interval_steps
        self.mesh = make_mesh(int(cfg.loss.get("group_size", -1) or -1),
                              self.tp_size(), self.pp_size())
        self.model = self.prepare_model(self.model)

        # batch divisibility guard (parity: core/initial.py:68-72, JAX
        # runner.py:84-91): each rank takes batch_size / W of a batch
        n_shards = batch_shards(self.mesh)
        if self.train_loaders and cfg.data.batch_size % n_shards != 0:
            raise ValueError(
                f"data.batch_size {cfg.data.batch_size} must be divisible by "
                f"the batch shard count {n_shards}")

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

    def tp_size(self) -> int:
        """Ranks per model group (``dist.tp_size``)."""
        return int(self.cfg.dist.get("tp_size", 1) or 1)

    def pp_size(self) -> int:
        """Pipeline stages (``dist.pp_size``)."""
        return int(self.cfg.dist.get("pp_size", 1) or 1)

    def prepare_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The model as the step trains it (a subclass shards it here)."""
        return model

    def build_step_fns(self) -> None:
        raise NotImplementedError

    def batch_processor(self, batch, device_batch=None) -> Dict[str, Any]:
        raise NotImplementedError

    def val_step(self, batch) -> None:
        raise NotImplementedError

    def init_hook(self) -> None:
        from simseg_tpu_torch.core.train_hooks import (CheckpointHook, LogHook,
                                                       PreemptionHook,
                                                       ProfileHook, WandbHook)

        self.register_hook(CheckpointHook(), Priority.LOW)
        # after CheckpointHook's own interval save (JAX runner.py:166-168)
        self.register_hook(PreemptionHook(), Priority.VERY_LOW)
        self.register_hook(LogHook(), Priority.VERY_LOW)
        if self.cfg.get("profile"):
            self.register_hook(ProfileHook(), Priority.HIGH)
        if (self.cfg.get("wandb", {}) or {}).get("enable", False):
            self.register_hook(WandbHook(), Priority.LOWEST)

    # -- shared plumbing ------------------------------------------------------------
    def _host_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's tensors on the host: captions tokenized when the batch
        has no ``input_ids``."""
        batch = dict(batch)
        if "input_ids" not in batch and "caption" in batch:
            if self.tokenizer is None:
                raise ValueError("a batch of captions needs a tokenizer")
            tok = self.tokenizer(list(batch["caption"]),
                                 max_length=self.cfg.model.max_length)
            batch["input_ids"] = tok["input_ids"]
            batch["attention_mask"] = tok["attention_mask"]
        out = {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
               for k, v in batch.items() if k in _BATCH_KEYS}
        if self.mesh is not None and self.mesh.tp > 1:
            out = broadcast_batch(out, self.mesh.rank - self.mesh.model_rank,
                                  self.mesh.model_host_group)
        if self.mesh is not None and self.mesh.pp > 1:
            out = broadcast_batch(out, self.mesh.rank_of_stage(0),
                                  self.mesh.pipe_host_group)
        return out

    def _finish_batch(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """uint8 images normalised and ids as int64, on the device."""
        if out["image"].dtype == torch.uint8:
            out["image"] = normalize_images(out["image"], self._norm_mean,
                                            self._norm_std)
        for k in ("input_ids", "attention_mask"):
            if k in out:
                out[k] = out[k].long()
        return out

    def _prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's tensors on the device, uint8 images normalised there."""
        return self._finish_batch({k: v.to(self.device, non_blocking=True)
                                   for k, v in self._host_batch(batch).items()})

    def _stage(self, batch: Dict[str, Any], stream) -> tuple:
        """(device tensors, event): the batch's tensors pinned and copied on
        ``stream``, the event recorded after the copies."""
        host = {k: v.pin_memory() for k, v in self._host_batch(batch).items()}
        with torch.cuda.stream(stream):
            moved = {k: v.to(self.device, non_blocking=True)
                     for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return moved, event

    def _take_staged(self, staged) -> Dict[str, torch.Tensor]:
        """A staged batch ready for the current stream."""
        moved, event = staged
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for v in moved.values():
            # the copy's memory belongs to the side stream's allocator pool
            v.record_stream(current)
        return self._finish_batch(moved)

    def _train_batch_iter(self):
        for loader in self.train_loaders:
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(self.epoch)
        if self.train_type == "shuffle":
            return iter(self.train_loaders[0])
        if self.train_type == "sequential":
            return sequential_batches(self.train_loaders)
        if self.train_type == "debias":
            return debias_batches(self.train_loaders, seed=self.epoch)
        raise NotImplementedError(f"data.train_type '{self.train_type}'")

    # -- loops -------------------------------------------------------------------
    def run(self) -> None:
        self.call_hook("before_run")
        while self.epoch < self.max_epochs:
            self.train()
            self.epoch += 1
            if (self.val_loaders and self.val_interval_steps < 0
                    and self.epoch % self.val_interval == 0):
                self._validate()
        self.call_hook("after_run")

    def _step_batch_stream(self, start_inner: int):
        """(inner_step, batch) pairs honouring the train_steps cap and the
        mid-epoch resume skip (clip_runner.py:267-278)."""
        for i, batch in enumerate(self._train_batch_iter()):
            if i >= self.train_steps:
                # exactly train_steps steps when data.train_steps caps a
                # longer loader (parity: epoch_runner.py:77-108)
                break
            if i < start_inner:
                continue
            yield i, batch

    def _staged_stream(self, pairs, size: int):
        """(inner_step, batch, staged) with the next ``size`` batches staged
        on the card ahead of the step that reads them (JAX
        ``_staged_stream``, ``simseg_tpu/core/runner.py:233-258``)."""
        stream = torch.cuda.Stream(self.device)
        ahead = collections.deque()
        it = iter(pairs)

        def put() -> bool:
            try:
                i, b = next(it)
            except StopIteration:
                return False
            ahead.append((i, b, self._stage(b, stream)))
            return True

        for _ in range(size):
            if not put():
                break
        while ahead:
            put()
            yield ahead.popleft()

    def train(self) -> None:
        self.model.train()
        self.call_hook("_before_train_epoch")
        start_inner = self.inner_step  # mid-epoch resume (clip_runner.py:267-278)
        self.inner_step = 0
        stream = self._step_batch_stream(start_inner)
        prefetch = int(self.cfg.data.get("device_prefetch", 2))
        if prefetch > 0 and self.device.type == "cuda":
            stream = self._staged_stream(stream, prefetch)
        else:
            stream = ((i, b, None) for i, b in stream)
        for i, batch, staged in stream:
            self.inner_step = i
            self.call_hook("_before_train_step")
            device_batch = None if staged is None else self._take_staged(staged)
            self.outputs = self.batch_processor(batch, device_batch)
            # count before the after-step hooks, so that a checkpoint records
            # the completed steps (parity: core/hooks/checkpoint.py:26)
            self.step += 1
            self.call_hook("_after_train_step")
            if (self.val_interval_steps > 0
                    and self.step % self.val_interval_steps == 0):
                self._validate()
        self.inner_step = 0
        self.call_hook("_after_train_epoch")

    def _validate(self) -> None:
        for i, loader in enumerate(self.val_loaders):
            self.val(loader, i)

    def val(self, loader, loader_idx: int = 0) -> None:
        """One pass over a validation loader (``data.val_steps`` > 0 caps
        its batches)."""
        self.state.val_loader_idx = loader_idx
        val_steps = self.cfg.data.get("val_steps", -1)
        self.state.val_steps = val_steps if val_steps > 0 else len(loader)
        self.call_hook("_before_val_epoch")
        for i, batch in enumerate(loader):
            if 0 < val_steps <= i:
                break
            self.state.val_inner_step = i
            self.call_hook("_before_val_step")
            self.val_step(batch)
            self.call_hook("_after_val_step")
        self.call_hook("_after_val_epoch")


class CLIPRunner(EpochRunner):
    """Contrastive pretraining runner (parity: clip_runner.py)."""

    def __init__(self, cfg, *args, **kwargs) -> None:
        if cfg.runner.name == "clip_bsgs":
            refuse_bsgs_parallel(cfg)
        super().__init__(cfg, *args, **kwargs)

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

    def prepare_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The model sharded over the mesh by the config's ``dist`` legs
        (JAX ``derive_state_shardings`` in ``build_step_fns``); a model
        that ``build_clip_model(cfg, mesh)`` made tensor-parallel keeps its
        TP."""
        d = self.cfg.dist
        return shard_model(model, self.mesh,
                           tp=int(d.get("tp_size", 1) or 1),
                           sp=bool(d.get("sp", False)),
                           fsdp=bool(d.get("fsdp", False)),
                           zero1=bool(d.get("zero1", False)),
                           ep=bool(d.get("moe_ep", False)))

    def build_step_fns(self) -> None:
        cfg = self.cfg
        if cfg.runner.name not in ("clip", "clip_bsgs"):
            raise NotImplementedError(f"runner '{cfg.runner.name}'")
        for enc in ("image_encoder", "text_encoder"):
            arch = dict(cfg.model[enc].get("arch", {}) or {})
            if arch.get("quant", "none") not in (None, "", "none"):
                raise NotImplementedError(f"{enc} arch quant is inference-only")
        # devices per gather group in the config; the loss takes samples
        self._group_samples = loss_group_samples(self.mesh, cfg.data.batch_size)
        self._eval_fn = make_eval_step(self.model)
        live_bn = (not cfg.model.get("freeze_cnn_bn", False)
                   and any(isinstance(m, BatchNorm) for m in self.model.modules()))
        if cfg.runner.name == "clip_bsgs":
            if live_bn:
                raise NotImplementedError(
                    "runner 'clip_bsgs' does not thread live BatchNorm "
                    "statistics (the two-pass re-forward would double-update "
                    "them); set model.freeze_cnn_bn=true or use "
                    "runner.name='clip'")
            self._step_fn = self._bsgs_step()
            return
        forward_fn = None
        if self.mesh is not None and self.mesh.pp > 1:
            from simseg_tpu_torch.parallel.pp import make_pp_forward

            forward_fn = make_pp_forward(self.model, self.mesh,
                                         int(cfg.dist.get("pp_micro", 4)))
        self._step_fn = make_train_step(
            self.model, self.optimizer,
            smoothing=cfg.loss.get("smoothing", 0.0),
            loss_name=cfg.loss.get("name", "NCE"),
            mixup_alpha_param=cfg.get("mixup", {}).get("alpha", 0.2),
            triplet_margin=cfg.loss.get("triplet_loss", {}).get("margin", 0.2),
            triplet_reduce=cfg.loss.get("triplet_loss", {}).get("reduce_mode", "max"),
            extra_losses=tuple(cfg.loss.get("extra_losses", []) or ()),
            seed=int(cfg.seed or 0),
            mesh=self.mesh, group_size=self._group_samples,
            mixup_pairing=cfg.get("mixup", {}).get("pairing", "shard"),
            bn_training=live_bn,
            moe_aux_weight=float(cfg.loss.get("moe_aux_weight", 0.01)),
            forward_fn=forward_fn,
        )

    def _bsgs_step(self):
        """The BSGS step, refusing what JAX's branch refuses
        (``simseg_tpu/core/runner.py:367-406``)."""
        cfg = self.cfg
        loss_name = cfg.loss.get("name", "NCE")
        if loss_name not in ("NCE", "MixUpNCE"):
            # the analytic gradients are derived for (mixup-)InfoNCE only
            raise NotImplementedError(
                f"runner 'clip_bsgs' supports loss NCE/MixUpNCE, got "
                f"'{loss_name}' (use runner.name='clip')")
        if cfg.loss.get("extra_losses", None):
            raise NotImplementedError(
                "runner 'clip_bsgs' does not support loss.extra_losses "
                "(use runner.name='clip')")
        # JAX's micro-batches are contiguous blocks of the global batch:
        # each rank runs its own share of them
        num_micro = max(1, cfg.data.batch_size // cfg.data.batch_size_train)
        world = batch_shards(self.mesh)
        if loss_name == "MixUpNCE" and num_micro % world:
            # the flip blocks (micro-batches) would span ranks
            raise NotImplementedError(
                f"runner 'clip_bsgs' with MixUpNCE needs each micro-batch on "
                f"one rank: data.batch_size // data.batch_size_train "
                f"({num_micro}) must be a multiple of the world size {world}")
        return make_bsgs_train_step(
            self.model, self.optimizer, num_micro=max(1, num_micro // world),
            smoothing=cfg.loss.get("smoothing", 0.0),
            group_size=self._group_samples,
            mixup=loss_name == "MixUpNCE",
            mixup_alpha_param=cfg.get("mixup", {}).get("alpha", 0.2),
            seed=int(cfg.seed or 0), mesh=self.mesh)

    def init_hook(self) -> None:
        """parity: clip_runner.py:44-63 hook wiring."""
        super().init_hook()
        if self.val_loaders:
            from simseg_tpu_torch.core.train_hooks import RetrievalEvalHook

            self.register_hook(RetrievalEvalHook(), Priority.VERY_LOW)

    def batch_processor(self, batch, device_batch: Optional[Dict] = None
                        ) -> Dict[str, Any]:
        """One train step (parity: clip_runner.py:216-251); the metrics stay
        on the device until a hook reads them. ``device_batch``: the batch
        already staged on the device, else prepared here."""
        if device_batch is None:
            device_batch = self._prepare_batch(batch)
        lr = self.lr_schedule(self.step)
        deterministic = self.cfg.runner.get("stable_random", "none") == "none"
        metrics = self._step_fn(device_batch, lr, self.step, deterministic)
        # the global batch's samples, as JAX counts them
        self.state.log_metrics.add_counter(
            "samples", device_batch["image"].shape[0] * batch_shards(self.mesh))
        return metrics

    def val_step(self, batch) -> None:
        """The batch's float32 embeddings (on the device) and ids into
        ``outputs`` for the retrieval hook."""
        img, txt = self._eval_fn(self._prepare_batch(batch))
        self.outputs = {"image_emb": img, "text_emb": txt,
                        "image_id": batch.get("image_id"),
                        "caption_id": batch.get("caption_id")}


class LinearProbRunner(EpochRunner):
    """ImageNet linear probing (JAX ``LinearProbRunner``,
    ``simseg_tpu/core/runner.py:488-619``; parity: linear_runner.py:20-200).

    A step: the batch's logits, the CE loss (``loss.smoothing``), backward,
    the optimizer (LARS in the YAML) on the parameters that are not frozen
    (a frozen tower's, ``^params/image_encoder/``, never; a CNN's running
    statistics are buffers, which no optimizer sees). With ``mixup.enable``
    the images and their smoothed one-hot labels are blended with the
    rows' mirror within each rank's shard (JAX's ``_block_flip`` over the
    data shards), by λ ~ Beta(α, α) drawn as JAX draws it: the step key
    ``fold_in(key(seed), step)`` split, its first half into ``beta``. In a
    world the loss and accuracies are the global batch's (means over the
    equal shards) and the gradients are summed over the ranks;
    ``samples`` counts the world's."""

    def frozen_patterns(self):
        if not self.cfg.model.image_encoder.get("trainable", True):
            return (r"^params/image_encoder/",)
        return ()

    def tp_size(self) -> int:
        # data-parallel only: build_step_fns refuses dist.tp_size
        return 1

    def pp_size(self) -> int:
        # JAX's probe builds a plain data mesh
        return 1

    def build_step_fns(self) -> None:
        cfg = self.cfg
        if int(cfg.dist.get("tp_size", 1) or 1) > 1:
            raise NotImplementedError(
                "linear probing is data-parallel only (the encoder is "
                "frozen and the classifier tiny) — use dist.tp_size=1")
        for key in ("sp", "zero1", "fsdp"):
            if cfg.dist.get(key, False):
                # JAX's probe step ignores them as well
                logger.warning("dist.%s is a CLIP-step leg: the linear probe "
                               "trains data-parallel", key)
        self._smoothing = cfg.loss.get("smoothing", 0.0)
        mixup_cfg = cfg.get("mixup", {}) or {}
        self._mixup_alpha = (float(mixup_cfg.get("alpha", 0.2))
                             if mixup_cfg.get("enable", False) else 0.0)
        self._num_classes = cfg.model.classifier.num_classes
        self._seed = int(cfg.seed or 0)

    def init_hook(self) -> None:
        super().init_hook()
        if self.val_loaders:
            from simseg_tpu_torch.core.train_hooks import LinearEvalHook

            self.register_hook(LinearEvalHook(), Priority.VERY_LOW)

    def _mixup(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from simseg_tpu_torch.utils import threefry

        mix_key, _ = threefry.split(step_key(self._seed, self.step))
        lam = float(threefry.beta(mix_key, self._mixup_alpha,
                                  self._mixup_alpha))
        onehot = torch.nn.functional.one_hot(batch["label"],
                                             self._num_classes).float()
        if self._smoothing > 0:
            # smoothed before the blend: CE is linear in the target
            onehot = (onehot * (1.0 - self._smoothing)
                      + self._smoothing / self._num_classes)
        images = batch["image"]
        return dict(batch, image=lam * images + (1.0 - lam) * images.flip(0),
                    label=lam * onehot + (1.0 - lam) * onehot.flip(0))

    def batch_processor(self, batch, device_batch: Optional[Dict] = None
                        ) -> Dict[str, Any]:
        from simseg_tpu_torch.models.linear_prob import linear_prob_loss_fn

        if device_batch is None:
            device_batch = self._prepare_batch(batch)
        lr = self.lr_schedule(self.step)
        if self._mixup_alpha > 0:
            device_batch = self._mixup(device_batch)
        loss, metrics = linear_prob_loss_fn(
            self.model, device_batch, smoothing=self._smoothing,
            soft_targets=self._mixup_alpha > 0)
        if self.mesh is None:
            loss.backward()
        else:
            (loss / self.mesh.data_size).backward()
            reduce_gradients(self.optimizer.params)
            metrics = {k: all_reduce_mean(v) for k, v in metrics.items()}
        self.optimizer.set_lr(lr)
        self.optimizer.step()
        metrics["lr"] = lr
        self.state.log_metrics.add_counter(
            "samples", device_batch["image"].shape[0] * batch_shards(self.mesh))
        return metrics

    def val_step(self, batch) -> None:
        """The batch's float32 logits (on the device) and labels into
        ``outputs`` for ``LinearEvalHook``."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                logits = self.model(self._prepare_batch(batch))
        finally:
            self.model.train(was_training)
        self.outputs = {"logits": logits, "label": np.asarray(batch["label"])}
