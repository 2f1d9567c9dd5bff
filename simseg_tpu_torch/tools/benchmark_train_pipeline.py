"""Real-loader against synthetic-batch train throughput (port of
``tools/benchmark_train_pipeline.py``).

How close does training fed by the real input pipeline (JPEGs on disk ->
threaded decode -> train transforms -> staged host-to-card copies and
normalisation on the card) come to the same step fed one staged batch?
The flagship towers (ViT-B/16 at 288 px + BERT-base, bf16 compute), batch
32, on JAX's synthetic JPEG shard (``benchmark_input_pipeline.make_shard``;
it holds at least ``batch x steps`` images, so the timed epoch runs every
step). One ``core/runner.py`` ``CLIPRunner`` a configuration, its
checkpoint and preemption hooks dropped; ``runner.train()`` is timed on
its second epoch (the first warms the caches and the allocator). The
synthetic lane loops the runner's own ``_step_fn`` on one batch from
``_prepare_batch``, with a device sync before the clock stops. Reported:
images/s of the real loader with ``data.device_prefetch`` 2 (the default)
and 0 (staging off), and of the synthetic lane.

    python -m simseg_tpu_torch.tools.benchmark_train_pipeline [--batch 32]
        [--steps 30] [--images 512] [--workers 8] [--size 500,375]
        [--device cpu]

Prints one JSON line (JAX's keys, and the card's line).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.tools.bench_common import add_device_arg, print_card
from simseg_tpu_torch.tools.benchmark_input_pipeline import make_shard

# JAX's towers (:61-69)
MODEL = ("model.image_encoder.tag=vit_base_patch16_224_in21k",
         "model.text_encoder.tag=bert-base-uncased",
         "model.projection.name=simple",
         "model.projection.dim=512",
         "model.pool.name=loda",
         "model.pool.loda.image_k=5",
         "model.pool.loda.text_k=1")
SIZE = 288


def overrides(root, batch, steps, workers, prefetch):
    """JAX's override list (:48-83)."""
    return [
        "epoch=2",
        "seed=0",
        "dist.bf16=true",
        "log.interval_train=1000000",
        "ckpt.step_interval=-1",
        f"ckpt.dir={root}/ckpt",
        "data.exp_name=pipe_bench",
        "data.train_type=shuffle",
        "data.train_name=[bench]",
        "data.enable_valid=false",
        f"data.batch_size={batch}",
        f"data.num_workers={workers}",
        f"data.train_steps={steps}",
        f"data.device_prefetch={prefetch}",
        "data.native_decode=true",
        f"data.data_path={root}/",
        *MODEL,
        "model.max_length=25",
        "loss.temperature.name=parameter",
        "loss.temperature.value=0.02",
        "optim.lr.name=constant_schedule",
        "optim.lr.init=1.0e-4",
        f"transforms.input_size={SIZE}",
        f"transforms.resize.size={SIZE}",
        # random_resize_crop reads its own size key, not input_size: without
        # it the loader yields 224-px batches and the step runs at 0.64x the
        # flagship's flops
        f"transforms.random_resize_crop.size={SIZE}",
        "transforms.train_transforms=[random_resize_crop]",
        "transforms.valid_transforms=[resize]",
    ]


def build_runner(root, vocab_file, batch, steps, workers, prefetch, device):
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.data.datasets import build_clip_dataloaders
    from simseg_tpu_torch.data.tokenizer import build_tokenizer
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

    cfg = update_cfg(task_cfg_init_fn, None,
                     argv=overrides(root, batch, steps, workers, prefetch),
                     target=new_base_cfg())
    tokenizer = build_tokenizer(cfg.model.text_encoder.tag,
                                vocab_file=vocab_file)
    torch.manual_seed(int(cfg.seed))
    model = build_clip_model(cfg)
    loaders = build_clip_dataloaders(cfg, tokenizer=tokenizer)
    return CLIPRunner(cfg, model, loaders, device=device, tokenizer=tokenizer)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_epoch(runner) -> float:
    """Seconds for one train epoch (``train_steps`` steps), synced."""
    t0 = time.perf_counter()
    runner.train()
    sync(runner.device)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--size", type=str, default="500,375")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split(","))

    from simseg_tpu_torch.data.tokenizer import make_test_vocab

    card = print_card(device)
    root = tempfile.mkdtemp(prefix="train_pipe_")
    try:
        # the timed epoch must run `steps` steps: a shard shorter than
        # batch * steps would end it early while the rate still divides
        # by `steps`
        make_shard(root, max(args.images, args.batch * args.steps), w, h)
        vocab = os.path.join(root, "vocab.txt")
        with open(vocab, "w") as f:
            for t in make_test_vocab(
                    ["a", "synthetic", "benchmark", "photo", "number"]
                    + [str(i) for i in range(10)]):
                f.write(t + "\n")

        results = {}
        for prefetch in (2, 0):
            runner = build_runner(root, vocab, args.batch, args.steps,
                                  args.workers, prefetch, device)
            # the loop alone: no checkpoints, no signal handlers
            runner._hooks = [hk for hk in runner._hooks
                             if type(hk).__name__ not in
                             ("CheckpointHook", "PreemptionHook")]
            timed_epoch(runner)  # epoch 1: warm
            runner.epoch = 1
            secs = timed_epoch(runner)
            results[f"real_prefetch{prefetch}"] = args.batch * args.steps / secs
            if prefetch == 2:
                # the bound from the same runner and step: one staged batch
                # looped train_steps times
                batch0 = next(iter(runner.train_loaders[0]))
                device_batch = runner._prepare_batch(batch0)
                sync(device)
                t0 = time.perf_counter()
                for i in range(args.steps):
                    runner._step_fn(device_batch, 1e-4, i)
                sync(device)
                results["synthetic"] = args.batch * args.steps / (
                    time.perf_counter() - t0)
            del runner

        ratio = results["real_prefetch2"] / results["synthetic"]
        out = {
            "batch": args.batch,
            "steps": args.steps,
            "img_per_s": {k: round(v, 1) for k, v in results.items()},
            "real_over_synthetic": round(ratio, 4),
            "card": card,
        }
        print(json.dumps(out))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
