"""Pipeline parallelism: GPipe microbatch pipelining of both towers' block
stacks over the pipe stages (port of ``simseg_tpu/parallel/pp.py``).

JAX stacks the blocks' parameters along a layer dim, shards it over a
``pipe`` mesh axis and runs the GPipe schedule inside a ``shard_map``,
activations hopping between stages with ``ppermute``. The port runs one
process a rank (``parallel/mesh.py``: ``dist.pp_size`` stages of
``world / pp`` data ranks, the pipe outermost), so a stage is a set of
processes, and its part of the stack is the slice of the tower's block
modules ``[s L / pp, (s + 1) L / pp)`` (JAX's ``stack_block_params`` has
no counterpart: that slice is the stage's row of the stacked dim):

- the embeddings run on every stage, as JAX runs them replicated over the
  pipe; stage 0 feeds them in, one microbatch (a contiguous block of the
  rank's rows, JAX's reshape) a tick;
- at tick t stage s runs microbatch t - s through its blocks (``ticks``);
  the ``pp - 1`` ticks where a stage has no microbatch are the bubble,
  where it runs nothing (JAX's bubbles run on zeros, and their outputs
  never reach the collected buffer); the activation hops to the next stage
  by a point-to-point send (``parallel/collectives.send_tensor``);
- the last stage collects the microbatches' outputs in order and
  broadcasts them to every stage of its data index (JAX's masked ``psum``),
  where the final norm, the projections and the loss run alike;
- the backward runs the schedule the other way, explicitly
  (``_Pipeline.backward``): the last stage takes the cotangent of its own
  loss (every stage holds the same), each stage backpropagates its
  microbatches through its blocks, last microbatch first, and sends the
  input's gradient to the stage before it. Block parameters gather their
  gradients on their own stage; ``parallel/sharding.
  reduce_pipeline_gradients`` takes every leaf from the one stage that
  computes it (``param_stages``).

Every rank holds the whole model (JAX keeps the canonical tree outside the
pipelined region too; compose with FSDP or ZeRO-1 to split its storage
within a stage). The blocks run as the towers run them elsewhere, so at
576 px the stages' ViT blocks take the attention kernels' training lane
(JAX keeps the einsum attention under PP only because it could not
validate Pallas inside ``shard_map``). BERT's padding bias rides the
schedule per microbatch. The forward is deterministic: dropout is refused,
as are MoE and ToMe towers (heterogeneous blocks), a CNN image tower and a
depth that the stages do not divide (JAX's refusals and exception types).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch

from simseg_tpu_torch.parallel.collectives import (broadcast_tensor,
                                                   recv_tensor, send_tensor)
from simseg_tpu_torch.parallel.mesh import DataMesh


def ticks(n_micro: int, n_stages: int, stage: int) -> List[int]:
    """The microbatches ``stage`` runs, in tick order: microbatch t - stage
    at tick t of the ``n_micro + n_stages - 1`` ticks, none in the bubble."""
    return [t - stage for t in range(n_micro + n_stages - 1)
            if 0 <= t - stage < n_micro]


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of this rank's stage: ``run(h, aux)`` applies the
    stage's blocks. Returns the last stage's outputs on every stage."""

    @staticmethod
    def forward(ctx, x, anchor, aux, run, n_micro, mesh, train):
        stage, last = mesh.stage, mesh.pp - 1
        group = mesh.pipe_group
        mb = x.chunk(n_micro)
        aux_mb = [None] * n_micro if aux is None else aux.chunk(n_micro)
        ins, outs = {}, {}
        for m in ticks(n_micro, mesh.pp, stage):
            h = mb[m] if stage == 0 else recv_tensor(
                mb[m].shape, x.dtype, x.device, mesh.rank_of_stage(stage - 1),
                group)
            if train:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = run(h, aux_mb[m])
                ins[m] = h
            else:
                out = run(h, aux_mb[m])
            if stage < last:
                send_tensor(out, mesh.rank_of_stage(stage + 1), group)
            outs[m] = out
        if stage == last:
            buf = torch.cat([outs[m].detach() for m in range(n_micro)])
        else:
            buf = torch.empty_like(x)
        buf = broadcast_tensor(buf.contiguous(), mesh.rank_of_stage(last), group)
        ctx.state = (ins, outs, n_micro, mesh)
        return buf

    @staticmethod
    def backward(ctx, grad):
        ins, outs, n_micro, mesh = ctx.state
        ctx.state = None
        stage, last = mesh.stage, mesh.pp - 1
        group = mesh.pipe_group
        # every stage holds the same loss: the last stage's cotangent is the
        # gradient of the output it computed
        grads = grad.chunk(n_micro)
        gx = {}
        for m in reversed(ticks(n_micro, mesh.pp, stage)):
            if stage == last:
                g = grads[m].contiguous()
            else:
                g = recv_tensor(outs[m].shape, outs[m].dtype, grad.device,
                                mesh.rank_of_stage(stage + 1), group)
            torch.autograd.backward(outs[m], g)
            if stage > 0:
                send_tensor(ins[m].grad, mesh.rank_of_stage(stage - 1), group)
            else:
                gx[m] = ins[m].grad
        gx_all = None
        if stage == 0 and ctx.needs_input_grad[0]:
            gx_all = torch.cat([gx[m] for m in range(n_micro)])
        return gx_all, None, None, None, None, None, None


def pipeline_blocks(blocks, x: torch.Tensor, mesh: DataMesh, n_micro: int,
                    aux: Optional[torch.Tensor] = None,
                    block_apply: Optional[Callable] = None) -> torch.Tensor:
    """``blocks`` (a tower's whole stack) over this rank's rows ``x`` (b, T,
    D) with the GPipe schedule of ``mesh``'s stages (JAX
    ``pipeline_blocks``). ``aux``: a per-row side input every stage needs
    (BERT's padding bias), cut into microbatches as ``x`` is;
    ``block_apply(block, h, aux_mb)`` applies one block (default:
    ``block(h)``)."""
    n_stages = mesh.pp
    depth = len(blocks)
    if depth % n_stages != 0:
        raise ValueError(f"depth {depth} not divisible by pp_size {n_stages}")
    if x.shape[0] % n_micro != 0:
        raise ValueError(
            f"per-device batch {x.shape[0] * mesh.data_size}/{mesh.data_size} "
            f"not divisible by pp_micro {n_micro}")
    per = depth // n_stages
    mine = list(blocks)[mesh.stage * per:(mesh.stage + 1) * per]
    if block_apply is None:
        def block_apply(block, h, _aux):
            return block(h)

    def run(h, a):
        for block in mine:
            h = block_apply(block, h, a)
        return h

    train = torch.is_grad_enabled()
    # the anchor makes the output require grad on every stage, so that every
    # stage runs the backward schedule
    anchor = x.new_empty(0).requires_grad_(train)
    return _Pipeline.apply(x, anchor, aux, run, n_micro, mesh, train)


def refuse_heterogeneous_tower(model) -> None:
    """JAX ``_refuse_heterogeneous_tower``: MoE blocks and token merging make
    the blocks differ, which the stage stack cannot express."""
    image_arch = dict(model.image_arch or ())
    text_arch = dict(model.text_arch or ())
    if (int(image_arch.get("moe_experts", 0) or 0) > 0
            or int(text_arch.get("moe_experts", 0) or 0) > 0):
        raise NotImplementedError(
            "pipeline parallelism does not combine with MoE blocks (the "
            "stage stack needs homogeneous block params, and the pp forward "
            "would drop the MoE aux loss)")
    if (int(image_arch.get("tome_r", 0) or 0) > 0
            or any(int(r) > 0 for r in image_arch.get("tome_schedule") or ())):
        raise NotImplementedError(
            "pipeline parallelism does not combine with token merging "
            "(tome_r shrinks the token count per block; the pipelined "
            "stage stack needs a homogeneous sequence length)")


def pp_image_tokens(model, images: torch.Tensor, mesh: DataMesh,
                    n_micro: int) -> torch.Tensor:
    """The ViT's (b, 1+N, D) tokens with its blocks pipelined: embeddings,
    the stages' blocks, the final norm; equal to ``model.image_tower(
    images)``."""
    refuse_heterogeneous_tower(model)
    vit = model.image_tower
    x = pipeline_blocks(vit.blocks, vit.embed(images), mesh, n_micro)
    return vit.norm(x)


def pp_text_feature(model, input_ids: torch.Tensor, attention_mask,
                    mesh: DataMesh, n_micro: int) -> torch.Tensor:
    """BERT's last hidden state (b, T, D) with its layers pipelined, the
    padding bias a per-microbatch input; equal to ``model.bert(input_ids,
    attention_mask)``."""
    from simseg_tpu_torch.ops.attention import padding_bias

    refuse_heterogeneous_tower(model)
    bert = model.bert
    bias = None
    if attention_mask is not None:
        bias = padding_bias(attention_mask, torch.float32)
    return pipeline_blocks(bert.encoder.layer, bert.embed(input_ids), mesh,
                           n_micro, aux=bias,
                           block_apply=lambda layer, h, a: layer(h, a))


def make_pp_forward(model, mesh: DataMesh, n_micro: int) -> Callable:
    """``forward(batch) -> (image_emb, text_emb, temperature)`` with both
    towers pipelined over ``mesh``'s stages (JAX ``make_pp_forward``), the
    train step's forward under ``dist.pp_size``; always deterministic."""
    if not getattr(model, "is_vit", False):
        raise NotImplementedError(
            "pipeline parallelism is implemented for the ViT image tower")
    refuse_heterogeneous_tower(model)
    if model.dropout or (model.projection_name == "complex"
                         and model.projection_dropout):
        raise NotImplementedError(
            "pipeline parallelism runs the forward deterministically; set "
            "model.dropout=0 (and complex-projection drop_out=0) or use "
            "dist.pp_size=1")
    for blocks in (model.image_tower.blocks, model.bert.encoder.layer):
        if len(blocks) % mesh.pp != 0:
            raise ValueError(f"depth {len(blocks)} not divisible by pp_size "
                             f"{mesh.pp}")

    def forward(batch):
        tokens = pp_image_tokens(model, batch["image"], mesh, n_micro)
        feat = tokens[:, 0] if model.pool_name == "identity" else tokens[:, 1:]
        img = model.forward_image_project(feat)
        mask = batch["attention_mask"]
        hidden = pp_text_feature(model, batch["input_ids"], mask, mesh, n_micro)
        txt = model.forward_text_project(model.text_feature_of(hidden), mask)
        return img, txt, model.temperature()

    return forward


_IMG = re.compile(r"^image_encoder\.model\.model\.blocks\.(\d+)\.")
_TXT = re.compile(r"^text_encoder\.model\.model\.encoder\.layer\.(\d+)\.")
_EMBED = re.compile(r"^(image_encoder\.model\.model\.(patch_embed|cls_token|"
                    r"pos_embed)|text_encoder\.model\.model\.embeddings\.)")


def param_stages(model, n_stages: int) -> Dict[str, int]:
    """The stage that computes each parameter's gradient: a block's its
    stage's, the embeddings' stage 0 (the only stage whose embeddings feed
    the pipeline), the rest (final norm, projections, temperature, which
    every stage computes alike) the last stage's."""
    per_img = len(model.image_tower.blocks) // n_stages
    per_txt = len(model.bert.encoder.layer) // n_stages
    out = {}
    for name, _ in model.named_parameters():
        m_img, m_txt = _IMG.match(name), _TXT.match(name)
        if m_img:
            out[name] = int(m_img[1]) // per_img
        elif m_txt:
            out[name] = int(m_txt[1]) // per_txt
        elif _EMBED.match(name):
            out[name] = 0
        else:
            out[name] = n_stages - 1
    return out
