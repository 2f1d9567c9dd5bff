"""Train-step time attribution (port of ``tools/benchmark_train_attrib.py``).

The flagship CLIP train step (ViT-B/16 at 288 px + BERT-base, bf16
compute, float32 AdamW) split into phases, each timed alone (per-step ms
at ``--batch``):

- ``loss_fwd``: the contrastive loss forward (``engine/train_step.
  clip_loss_fn``), no autograd graph;
- ``grads``: the same with its backward (``torch.autograd.grad``);
- ``image_fwd_bwd`` / ``text_fwd_bwd``: one tower and its projection,
  forward and backward;
- ``optimizer``: one ``core/optim.py`` AdamW update over every parameter
  and moment, on gradients computed once;
- ``full_step``: the production step (``make_train_step``).

JAX's ``full_step_nodonate`` and donation lines have no eager PyTorch
counterpart (the optimizer updates in place: ``full_step`` is the
production step), so the tool prints them with that reason and no number.
The compiled-step cost line becomes ``torch.utils.flop_counter.
FlopCounterMode`` over one step against the analytic 3x forward; bytes are
not counted. The AdamW traffic floor uses the card's published HBM rate
(``bench_common.card_peaks``).

    python -m simseg_tpu_torch.tools.benchmark_train_attrib [--batch 32]
        [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.core.optim import _global_norm
from simseg_tpu_torch.tools.bench_common import (add_device_arg, card_peaks,
                                                 flagship_flops, print_card,
                                                 timed_secs)
from simseg_tpu_torch.tools.benchmark_components import (FLAGSHIP, TEXT_LEN,
                                                         adamw, build_model)

PHASES = ("loss_fwd", "grads", "image_fwd_bwd", "text_fwd_bwd", "optimizer",
          "full_step")
NO_COUNTERPART = {
    "full_step_nodonate": "no eager PyTorch counterpart: JAX's step without "
                          "buffer donation; the port's optimizer updates in "
                          "place, so full_step is the production step",
    "donation saves": "not measured: eager PyTorch donates no buffers (the "
                      "optimizer updates in place)",
    "bytes accessed": "not counted: FlopCounterMode counts operations only",
}
LR = 1e-4


def _grad_norm(loss, params) -> torch.Tensor:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return _global_norm([g for g in grads if g is not None])


def phase_fns(model, batch, opt) -> dict:
    """Phase name -> a callable running that phase once: the loss, the
    gradients' global norms, or (``optimizer``) one update from
    ``model``'s gradients of ``batch``, computed here once; ``full_step``
    returns the step's metrics."""
    from simseg_tpu_torch.engine.train_step import (clip_loss_fn,
                                                    make_train_step)

    params = [p for p in model.parameters() if p.requires_grad]

    def loss_fwd():
        with torch.no_grad():
            return clip_loss_fn(model, batch)[0]

    def grads():
        return _grad_norm(clip_loss_fn(model, batch)[0], params)

    def image_fwd_bwd():
        tokens = model.forward_image_tokens(batch["image"])
        emb = model.forward_image_project(tokens[:, 1:])
        return _grad_norm(emb.float().sum(), params)

    def text_fwd_bwd():
        mask = batch["attention_mask"]
        hidden = model.forward_text_feature(batch["input_ids"], mask)
        emb = model.forward_text_project(hidden, mask)
        return _grad_norm(emb.float().sum(), params)

    once = torch.autograd.grad(clip_loss_fn(model, batch)[0], params)

    def optimizer():
        # the gradients as they were: the step clears them
        for p, g in zip(params, once):
            p.grad = g
        opt.set_lr(LR)
        return opt.step()

    step = make_train_step(model, opt)

    def full_step():
        return step(batch, LR)

    return {"loss_fwd": loss_fwd, "grads": grads,
            "image_fwd_bwd": image_fwd_bwd, "text_fwd_bwd": text_fwd_bwd,
            "optimizer": optimizer, "full_step": full_step}


def update_norms(model, opt) -> dict:
    """The parameters' and AdamW moments' global norms (the optimizer
    phase's outputs)."""
    moments = [v for st in opt.base.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    return {"params": _global_norm(list(model.parameters())).item(),
            "moments": _global_norm(moments).item()}


def step_flops(step) -> float:
    """The flops ``FlopCounterMode`` counts over one call of ``step``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    return float(counter.get_total_flops())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=10)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch

    card = print_card(device)
    model = build_model(device).train()
    size = FLAGSHIP["img_size"]
    vocab = model.bert.embeddings.word_embeddings.num_embeddings
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.normal(size=(b, size, size, 3))
                                  .astype(np.float32)).to(device),
        "input_ids": torch.from_numpy(rng.integers(0, vocab, (b, TEXT_LEN))
                                      .astype(np.int64)).to(device),
        "attention_mask": torch.ones((b, TEXT_LEN), dtype=torch.int64,
                                     device=device)}
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw(model)
    fns = phase_fns(model, batch, opt)

    results = {name: timed_secs(fns[name], iters=args.iters, device=device)
               for name in PHASES}

    print(f"\n== train-step attribution (batch {b}, {card}) ==")
    for k, v in results.items():
        print(f"{k:18s} {1e3 * v:8.2f} ms/step   {b / v:8.1f} img/s")
    print(f"{'full_step_nodonate':18s} {NO_COUNTERPART['full_step_nodonate']}")
    bwd = results["grads"] - results["loss_fwd"]
    resid = results["full_step"] - results["grads"] - results["optimizer"]
    print(f"\nfwd {1e3 * results['loss_fwd']:.2f} ms + bwd {1e3 * bwd:.2f} ms "
          f"+ opt {1e3 * results['optimizer']:.2f} ms; "
          f"residual(full - grads - opt) {1e3 * resid:.2f} ms; "
          f"donation saves: {NO_COUNTERPART['donation saves']} [{card}]")
    peaks, peak_note = card_peaks(device)
    traffic = 7 * 4 * n_params
    floor = (f"{1e3 * traffic / peaks[1]:.2f} ms floor at the card's "
             f"{peaks[1] / 1e12:.2f} TB/s" if peaks else f"no floor: {peak_note}")
    print(f"params: {n_params / 1e6:.1f} M; AdamW traffic ~ "
          f"{traffic / 1e9:.2f} GB/step ({floor})")

    vit, bert = flagship_flops()
    analytic = 3.0 * b * (vit + bert)
    flops = step_flops(fns["full_step"])
    print(f"FlopCounterMode: {flops / 1e12:.3f} TFLOP/step "
          f"(analytic 3x-fwd {analytic / 1e12:.3f}); bytes accessed "
          f"{NO_COUNTERPART['bytes accessed']}")
    results["tflop_counted"] = flops / 1e12
    results["tflop_analytic"] = analytic / 1e12
    return results


if __name__ == "__main__":
    main()
