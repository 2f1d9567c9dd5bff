"""Serving export: ahead-of-time inference graphs through ``torch.export``
(port of ``simseg_tpu/serving.py``).

The zero-shot segmentation pipeline (normalisation -> image tower ->
projections -> similarity decode -> CRF -> closing -> argmax) or the
retrieval embedding forward is staged into one ``torch.export`` artifact
with the weights and the class-text bank in it. A server loads the
artifact and calls it with raw uint8 images: no model code, config tree,
normalisation constants or checkpoint bridge is needed at serving time.
The seg pipeline is the SAME ``tasks/seg_eval.make_seg_predict`` the eval
tool runs (with every ``cfg.seg_eval`` knob), so a loaded artifact gives
the live pipeline's predictions.

Where JAX's StableHLO artifact needs nothing but JAX to run, a
``torch.export`` artifact names the port's hand-written kernels as custom
ops (``simseg::crf_mean_field``, ``simseg::crf_decode_tail``,
``simseg::bilateral_matvec``, ``simseg::flash_attention_fwd``), so a server
needs ``simseg_tpu_torch`` installed: ``load_artifact`` imports the ops'
registrations, and each kernel builds at its first launch.

The image size is static per artifact: export one artifact per size. The
batch axis is exported dynamic (``torch.export.Dim.AUTO``): the graphs have
no cross-sample reduction, so one artifact serves any batch of 2 or more
(the size the tracer assumes non-trivial) where the traced code did not fix
it, which is what lets ``load_artifact(devices=...)`` give each device a
slice of a call's batch (JAX's static artifact is sharded by GSPMD
instead). An artifact runs on the device it was exported on.

The staged module holds only what its graph reads: the seg artifact the
image tower, its pooling and projection, and the bank (not the text
tower); the retrieval artifact both towers.
"""

from __future__ import annotations

import functools
import io
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.transforms import normalize_images
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.pooling import l2_normalize


class ImageSide(nn.Module):
    """The image half of a ``CLIPModel``: its tower, projection and pooling,
    sharing the model's modules and state-dict names (``image_encoder.*``,
    ``image_projection.*``), with the methods the seg pipeline calls."""

    image_tower = CLIPModel.image_tower
    patch_size = CLIPModel.patch_size
    forward_image_tokens = CLIPModel.forward_image_tokens
    forward_image_project = CLIPModel.forward_image_project
    project_image_tokens = CLIPModel.project_image_tokens

    def __init__(self, model: CLIPModel) -> None:
        super().__init__()
        self.image_encoder = model.image_encoder
        self.image_projection = model.image_projection
        self.is_vit = model.is_vit
        self.pool_name = model.pool_name
        self.image_k = model.image_k
        self.projection_name = model.projection_name


class SegInfer(nn.Module):
    """raw uint8 images (B, S, S, 3) -> (pred (B, S, S) int32, best_w f32):
    ``make_seg_predict`` over the image side with the bank as a buffer."""

    def __init__(self, model: CLIPModel, bank: torch.Tensor, **predict_kw):
        super().__init__()
        from simseg_tpu_torch.tasks.seg_eval import make_seg_predict

        self.model = ImageSide(model)
        self.register_buffer("text_bank", bank)
        self._predict = make_seg_predict(self.model, **predict_kw)

    def forward(self, images_u8: torch.Tensor):
        return self._predict(images_u8, self.text_bank)


class EmbedInfer(nn.Module):
    """(images, input_ids, attention_mask) -> float32 (image_emb,
    text_emb): the retrieval forward, normalising raw uint8 images with
    ``mean`` / ``std`` when they are given."""

    def __init__(self, model: CLIPModel, mean=None, std=None) -> None:
        super().__init__()
        self.model = model
        self.mean, self.std = mean, std

    @torch.no_grad()
    def forward(self, images, input_ids, attention_mask):
        if self.mean is not None:
            images = normalize_images(images, self.mean, self.std)
        img, txt, _ = self.model({"image": images, "input_ids": input_ids,
                                  "attention_mask": attention_mask},
                                 deterministic=True)
        return img.float(), txt.float()


class Unbaked(nn.Module):
    """A staged module with its weights as the first argument:
    ``forward(params, *data)`` runs ``staged`` with ``params`` (name ->
    tensor, its parameters and buffers, the int8 caches included) through
    ``torch.func.functional_call``. ``staged`` is kept out of the module
    tree, so an export of this module holds no weight; ``params`` holds
    the staged module's own."""

    def __init__(self, staged: nn.Module) -> None:
        super().__init__()
        self.__dict__["staged"] = staged
        self.params: Dict[str, torch.Tensor] = {
            name: t.detach() for name, t in
            (*staged.named_parameters(), *staged.named_buffers())}

    def forward(self, params: Dict[str, torch.Tensor], *data):
        return torch.func.functional_call(self.staged, params, data)


def make_seg_infer_fn(model: CLIPModel, text_bank, cfg, num_classes: int,
                      top_cls_num: int, patch_size: Optional[int] = None,
                      bake_weights: bool = True, device=None) -> nn.Module:
    """raw uint8 images (B, S, S, 3) -> (pred, best_w) on ``device`` (the
    model is moved there and into eval mode): ``make_seg_predict`` with the
    knobs ``cfg.seg_eval`` gives the eval tool (``scales``, ``window``,
    ``bilateral_stride``, ``crf_backend``, ``crf_dtype``) and the
    ``cfg.transforms`` size and normalisation, over the image side and the
    L2-normed ``text_bank`` (C, D).

    bake_weights=False: an ``Unbaked`` module, ``forward(params, images)``,
    for the separate-weights layout (``export_artifact_separate``), with
    its weights in ``.params``."""
    device = resolve_device(device)
    model = model.to(device).eval()
    seg = cfg.get("seg_eval", {}) or {}
    window = seg.get("window", {}) or {}
    bank = l2_normalize(torch.as_tensor(text_bank, dtype=torch.float32,
                                        device=device))
    fn = SegInfer(
        model, bank, num_classes=num_classes, top_cls_num=top_cls_num,
        input_size=cfg.transforms.input_size,
        mean=tuple(cfg.transforms.normalize.mean),
        std=tuple(cfg.transforms.normalize.std),
        bilateral_stride=seg.get("bilateral_stride", 8),
        patch_size=patch_size, scales=tuple(seg.get("scales", (1.0,))),
        window_size=int(window.get("size", -1)),
        window_stride=int(window.get("stride", -1)),
        crf_backend=seg.get("crf_backend", "auto"),
        compute_dtype=seg.get("crf_dtype", "auto"), device=device)
    return fn if bake_weights else Unbaked(fn)


def make_embed_fn(model: CLIPModel, cfg=None, bake_weights: bool = True,
                  device=None) -> nn.Module:
    """(images, input_ids, attention_mask) -> float32 (image_emb,
    text_emb) on ``device``: the retrieval forward, with the normalisation
    of ``cfg.transforms`` baked in when ``cfg`` is given (raw uint8
    images), else on normalised float images. bake_weights=False: an
    ``Unbaked`` module, ``forward(params, images, ids, mask)``."""
    device = resolve_device(device)
    model = model.to(device).eval()
    mean = std = None
    if cfg is not None:
        mean = tuple(cfg.transforms.normalize.mean)
        std = tuple(cfg.transforms.normalize.std)
    fn = EmbedInfer(model, mean, std)
    return fn if bake_weights else Unbaked(fn)


def _batch_dynamic(example):
    """The dynamic-shape spec of an example argument: its leading axis
    ``Dim.AUTO`` for a tensor, nothing for a dict of weights."""
    if isinstance(example, dict):
        return {k: None for k in example}
    return {0: torch.export.Dim.AUTO}


def export_artifact(fn: nn.Module, example_args: Sequence) -> bytes:
    """Stage ``fn`` at the example shapes (tensors on the device the
    artifact serves on; a dict argument holds weights) through
    ``torch.export``, the batch axis dynamic where the graph allows, and
    serialise it (without the example inputs: the weights of the separate
    layout would be written twice)."""
    example_args = tuple(example_args)
    dynamic = tuple(_batch_dynamic(a) for a in example_args)
    if isinstance(fn, Unbaked):
        dynamic = (dynamic[0], dynamic[1:])  # forward(params, *data)
    with torch.no_grad():
        program = torch.export.export(fn, example_args, strict=False,
                                      dynamic_shapes=dynamic)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_artifact(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _served(module: Callable) -> Callable:
    """``module`` called without autograd: a loaded graph's weights are
    parameters, and a call under grad mode would record a graph."""
    def call(*args):
        with torch.no_grad():
            return module(*args)
    return call


def register_ops() -> None:
    """Import the modules that register the port's custom ops, which a
    loaded graph calls."""
    import simseg_tpu_torch.ops.crf_fused  # noqa: F401
    import simseg_tpu_torch.ops.crf_pallas  # noqa: F401
    import simseg_tpu_torch.ops.flash_attention  # noqa: F401


def _user_inputs(program):
    """The (name, example value) of the program's user inputs, in order."""
    names = program.graph_signature.user_inputs
    vals = {n.name: n.meta.get("val") for n in program.graph.nodes
            if n.op == "placeholder"}
    return [(name, vals[name]) for name in names]


def _program_device(program) -> torch.device:
    """The device of the program's first tensor input."""
    for _, val in _user_inputs(program):
        if isinstance(val, torch.Tensor):
            return val.device
    raise ValueError("the artifact takes no tensor input")


class DataParallel:
    """One copy of a single-device program per device of ``devices``: a
    call splits every data argument along its leading (batch) axis, runs
    each slice on its device and concatenates the results on the first
    device. Weights (the separate layout) are replicated, one copy per
    device. The graphs have no cross-sample reduction, so each sample's
    result is the single-device call's math."""

    def __init__(self, path: str, devices, weights=None) -> None:
        from torch.export.passes import move_to_device_pass

        self.devices = [torch.device(d) for d in devices]
        program = torch.export.load(path)
        for name, val in _user_inputs(program)[len(weights or ()):]:
            shape = tuple(getattr(val, "shape", ()))
            if not shape or isinstance(shape[0], int):
                raise ValueError(
                    f"artifact input {name} {shape} cannot be batch-sharded "
                    f"over {len(self.devices)} devices: its batch axis is "
                    "static in the exported graph")
        programs = [program] + [torch.export.load(path)
                                for _ in self.devices[1:]]
        self.modules = [move_to_device_pass(p, str(d)).module()
                        for p, d in zip(programs, self.devices)]
        self.weights = (None if weights is None else
                        [{k: v.to(d) for k, v in weights.items()}
                         for d in self.devices])

    @torch.no_grad()
    def __call__(self, *args):
        n = len(self.devices)
        for a in args:
            if a.shape[0] % n:
                raise ValueError(
                    f"input {tuple(a.shape)} cannot be batch-sharded over {n} "
                    "devices (leading dim must be divisible); call with a "
                    "divisible batch or serve on fewer devices")
        parts = [a.chunk(n, dim=0) for a in args]
        outs = []
        for i, (dev, module) in enumerate(zip(self.devices, self.modules)):
            data = [p[i].to(dev) for p in parts]
            if self.weights is not None:
                data = [self.weights[i]] + data
            outs.append(module(*data))
        first = self.devices[0]
        return tuple(torch.cat([o[j].to(first) for o in outs])
                     for j in range(len(outs[0])))


def load_artifact(path: str, devices: Optional[Sequence] = None) -> Callable:
    """A callable of an artifact written by ``save_artifact``, on the
    device it was exported on.

    devices: serve the same single-device artifact data-parallel over these
    devices (``DataParallel``): a call's batch must be divisible by their
    number, else ``ValueError``; an artifact whose batch axis its trace
    fixed is refused at load time."""
    register_ops()
    if devices is not None:
        return DataParallel(path, devices)
    return _served(torch.export.load(path).module())


def export_artifact_separate(fn: Unbaked, params: Dict[str, torch.Tensor],
                             example_args: Sequence, path: str) -> None:
    """Separate-weights layout: ``fn(params, *data)`` (an ``Unbaked``
    module) is staged with the weights as graph inputs and written to
    ``path``, and ``params`` to ``<path>.weights`` (``torch.save`` of the
    tensors on the CPU, the int8 caches included). The graph stays a few
    MB and weights rotate by replacing one file, without re-export;
    ``load_artifact_separate`` binds them back."""
    save_artifact(path, export_artifact(fn, (params,) + tuple(example_args)))
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               path + ".weights")


def load_artifact_separate(path: str, devices: Optional[Sequence] = None
                           ) -> Callable:
    """A data-only callable of a separate-weights artifact: the weights of
    ``<path>.weights`` (read with ``weights_only=True``) moved once to the
    artifact's device, or replicated over ``devices`` (see
    ``load_artifact``), and bound as the first argument."""
    register_ops()
    weights = torch.load(path + ".weights", map_location="cpu",
                         weights_only=True)
    if devices is not None:
        return DataParallel(path, devices, weights)
    program = torch.export.load(path)
    device = _program_device(program)
    weights = {k: v.to(device) for k, v in weights.items()}
    return _served(functools.partial(program.module(), weights))
