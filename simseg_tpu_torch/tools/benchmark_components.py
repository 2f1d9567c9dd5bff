"""Component-level throughput (port of ``tools/benchmark_components.py``).

Images/s by lane for the flagship (ViT-B/16 at 288 px, BERT-base, 512-d
simple projection, LoDA 5/1, bf16 compute over float32 parameters, seeded
weights), under JAX's lane names: the towers' forwards, the decode in the
stream (JAX ``pallas``) and dense (``xla``) lanes, the segmentation end to
end (the default decode), the MoE-8, ToMe 8/16 and int8 image towers
(the port's ``image_arch`` knobs), and the train step
(``engine/train_step.make_train_step`` with ``core/optim.py``'s AdamW at
JAX's betas, eps and decay) with and without ToMe 16. Then the MFU line,
against the card's published bf16 peak (``bench_common.card_peaks``).

    python -m simseg_tpu_torch.tools.benchmark_components [--batch 16]
        [--iters 20] [--only train] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.tools.bench_common import (add_device_arg, card_peaks,
                                                 flagship_flops, launches_of,
                                                 print_card, timed_rate)

FLAGSHIP = dict(image_tag="vit_base_patch16_224_in21k", img_size=288,
                text_tag="bert-base-uncased", projection_name="simple",
                projection_dim=512, pool_name="loda", image_k=5, text_k=1,
                temperature_name="parameter", temperature_init=0.02)
TEXT_LEN = 25
CLASSES = 21

# JAX's lanes, in its order (:61-205)
LANES = ("image_tower_fwd", "text_tower_fwd", "seg_decode_pallas",
         "seg_decode_xla", "seg_end_to_end", "image_tower_fwd_moe8",
         "image_tower_fwd_tome8", "image_tower_fwd_tome16",
         "image_tower_fwd_int8", "clip_train_step", "clip_train_step_tome16")
# JAX's crf_backend names of the decode lanes
DECODE_BACKENDS = ("pallas", "xla")
# JAX's AdamW (:166-176)
ADAMW = dict(betas=(0.9, 0.98), eps=1e-6, weight_decay=0.001)


def lanes(only: str = "") -> list:
    """The lanes ``--only`` selects: those whose name holds it."""
    return [n for n in LANES if (only in n if only else True)]


def build_model(device, image_arch=(), seed: int = 0, state=None):
    """The flagship on ``device``, float32 parameters and bf16 compute,
    weights from ``seed`` or ``state``."""
    from simseg_tpu_torch.models.clip import CLIPModel

    torch.manual_seed(seed)
    with torch.device(device):
        model = CLIPModel(image_arch=tuple(image_arch) or None,
                          compute_dtype=torch.bfloat16, **FLAGSHIP)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def adamw(model):
    """``core/optim.build_optimizer`` with JAX's AdamW settings."""
    from simseg_tpu_torch.core.optim import build_optimizer
    from simseg_tpu_torch.utils.collections import AttrDict, OpenDict

    cfg = AttrDict()
    cfg.optim = AttrDict()
    cfg.optim.name = "torch.optim.AdamW"
    cfg.optim.param = OpenDict(**ADAMW)
    cfg.optim.param_group_rules = OpenDict()
    cfg.optim.grad_clip = OpenDict()
    return build_optimizer(cfg, model)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--only", default="",
                        help="run only lanes whose name contains this "
                             "substring")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    run = lanes(args.only)

    from simseg_tpu_torch.engine.train_step import make_train_step
    from simseg_tpu_torch.ops.pooling import l2_normalize
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn

    card = print_card(device)
    size, dim = FLAGSHIP["img_size"], FLAGSHIP["projection_dim"]
    model = build_model(device).eval()
    patch = model.patch_size
    grid = size // patch
    vocab = model.bert.embeddings.word_embeddings.num_embeddings
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(a).to(device)

    images = on(rng.normal(size=(b, size, size, 3)).astype(np.float32))
    raw = on(rng.integers(0, 255, (b, size, size, 3)).astype(np.uint8))
    ids = on(rng.integers(0, vocab, (b, TEXT_LEN)).astype(np.int64))
    mask = torch.ones((b, TEXT_LEN), dtype=torch.int64, device=device)
    tb = rng.normal(size=(CLASSES, dim)).astype(np.float32)
    tb = on(tb / np.linalg.norm(tb, axis=1, keepdims=True))

    def timed(fn, *arrs, batch=b, iters=args.iters, trials=3):
        return timed_rate(fn, arrs, batch, iters=iters, trials=trials,
                          device=device)

    def image_fwd(m):
        @torch.no_grad()
        def fn(x):
            return m.forward_image_tokens(x)
        return fn

    results, launches = {}, {}
    if "image_tower_fwd" in run:
        results["image_tower_fwd"] = timed(image_fwd(model), images)

    if "text_tower_fwd" in run:
        @torch.no_grad()
        def text_fwd(i, m):
            return model.forward_text_feature(i, m)

        results["text_tower_fwd"] = timed(text_fwd, ids, mask)

    for backend in DECODE_BACKENDS:
        if f"seg_decode_{backend}" not in run:
            continue
        decode = make_seg_decode_fn(CLASSES, size, patch, 10, 5,
                                    crf_backend=backend)
        dense = l2_normalize(on(rng.normal(size=(b, grid * grid, dim))
                                .astype(np.float32)))
        pooled = l2_normalize(on(rng.normal(size=(b, dim)).astype(np.float32)))
        name = f"seg_decode_{backend}"
        launches[name] = launches_of(decode, dense, pooled, tb, raw)
        results[name] = timed(decode, dense, pooled, tb, raw)

    if "seg_end_to_end" in run:
        decode = make_seg_decode_fn(CLASSES, size, patch, 10, 5)

        @torch.no_grad()
        def end_to_end(x, r, t):
            patches = model.forward_image_tokens(x)[:, 1:]
            pooled = model.forward_image_project(patches)
            dense = l2_normalize(model.project_image_tokens(patches).float())
            return decode(dense, pooled.float(), t, r)

        launches["seg_end_to_end"] = launches_of(end_to_end, images, raw, tb)
        results["seg_end_to_end"] = timed(end_to_end, images, raw, tb)

    if "image_tower_fwd_moe8" in run:
        # 8 experts in every second block (ops/moe.py): the dispatch's cost
        # against the dense MLP
        moe = build_model(device, (("moe_experts", 8),), seed=1).eval()
        results["image_tower_fwd_moe8"] = timed(image_fwd(moe), images)
        del moe

    state = model.state_dict()
    for tome_r in (8, 16):
        if f"image_tower_fwd_tome{tome_r}" not in run:
            continue
        tome = build_model(device, (("tome_r", tome_r),), state=state).eval()
        results[f"image_tower_fwd_tome{tome_r}"] = timed(image_fwd(tome), images)
        del tome

    if "image_tower_fwd_int8" in run:
        # int8 products (ops/quant.py) with per-token activation scales, the
        # same float32 parameters
        int8 = build_model(device, (("quant", "int8"),), state=state).eval()
        results["image_tower_fwd_int8"] = timed(image_fwd(int8), images)
        del int8

    train_batch = {"image": images, "input_ids": ids, "attention_mask": mask}
    for name, arch in (("clip_train_step", ()),
                       ("clip_train_step_tome16", (("tome_r", 16),))):
        if name not in run:
            continue
        # a fresh copy of the weights and a fresh AdamW state a lane
        train_model = build_model(device, arch, state=state).train()
        step = make_train_step(train_model, adamw(train_model))
        results[name] = timed(lambda: step(train_batch, 1e-4),
                              iters=max(args.iters // 2, 5))
        del train_model, step

    vit, bert = flagship_flops()
    train_flops = 3.0 * (vit + bert)
    peaks, peak_note = card_peaks(device)

    print(f"\n== component throughput (batch {b}, images/sec, {card}) ==")
    for k, v in results.items():
        print(f"{k:24s} {v:10.1f}"
              + (f"  kernel launches a call {launches[k]}" if k in launches
                 else ""))
    if "clip_train_step" in results and "image_tower_fwd" in results:
        if peaks is None:
            print(f"\ntrain_flops/sample ~ {train_flops / 1e9:.1f} GFLOP; "
                  f"train-step MFU not printed: {peak_note}")
        else:
            mfu = results["clip_train_step"] * train_flops / peaks[0]
            fwd_mfu = results["image_tower_fwd"] * vit / peaks[0]
            print(f"\ntrain_flops/sample ~ {train_flops / 1e9:.1f} GFLOP; "
                  f"train-step MFU ~ {100 * mfu:.1f}% of the card's bf16 peak "
                  f"(image-tower fwd MFU ~ {100 * fwd_mfu:.1f}%) [{card}]")
    return results


if __name__ == "__main__":
    main()
