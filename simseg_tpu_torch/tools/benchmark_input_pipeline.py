"""Input-pipeline throughput: loader-only images/s, PIL against the native
decode (port of ``tools/benchmark_input_pipeline.py``).

Writes JAX's synthetic CC-like JPEG shard (``make_shard``: the same bytes),
then iterates the port's training loader (``data/datasets.py``
``CsvPairDataset`` and its threaded ``DataLoader``) under the train
transforms (``random_resize_crop,autoaug`` by default) and reports
images/s for the PIL decode, and the native library's
(``data/native.py``) wherever it builds, over worker counts. Where the
library does not build (the card machine has no ``jpeglib.h``), the native
lane prints why (``native.build_error()``) and no number.

    python -m simseg_tpu_torch.tools.benchmark_input_pipeline [--images 512]
        [--size 500,375] [--workers 2,4,8]
        [--transforms random_resize_crop,autoaug] [--device cpu]

Prints one JSON line per configuration plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.tools.bench_common import add_device_arg, print_card


def make_shard(root: str, n: int, w: int, h: int, seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "bench", "train")
    os.makedirs(d, exist_ok=True)
    rows = ["image,caption"]
    for i in range(n):
        # low-frequency content so files have JPEG-realistic size
        small = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        name = f"{i:05d}.jpg"
        img.save(os.path.join(d, name), "JPEG", quality=90)
        rows.append(f"{name},a synthetic benchmark photo number {i}")
    with open(os.path.join(root, "bench", "train_anno.csv"), "w") as f:
        f.write("\n".join(rows))


def build_cfg(data_path: str, transforms: list, batch_size: int,
              workers: int, native: bool):
    from simseg_tpu_torch.config import new_base_cfg
    from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

    cfg = new_base_cfg()
    task_cfg_init_fn(cfg)
    cfg.data.data_path = data_path
    cfg.data.train_name = ["bench"]
    cfg.data.batch_size = batch_size
    cfg.data.num_workers = workers
    cfg.data.native_decode = native
    cfg.data.enable_valid = False
    cfg.transforms.train_transforms = list(transforms)
    cfg.transforms.random_resize_crop.size = 224
    cfg.model.max_length = 25
    return cfg


def measure(cfg, vocab, epochs: int = 1) -> float:
    from simseg_tpu_torch.data.datasets import CsvPairDataset, DataLoader
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
    from simseg_tpu_torch.data.transforms import build_transforms

    tok = WordPieceTokenizer(vocab)
    tf = build_transforms(cfg, "train")
    ds = CsvPairDataset(cfg, "bench", tok, tf, "train")
    loader = DataLoader(ds, cfg.data.batch_size, shuffle=True, drop_last=True,
                        num_workers=cfg.data.num_workers)
    # warm one batch (thread pool spin-up, native lib dlopen)
    next(iter(loader))
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            n += batch["image"].shape[0]
    return n / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--size", type=str, default="500,375")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--workers", type=str, default="")
    ap.add_argument("--transforms", type=str,
                    default="random_resize_crop,autoaug")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split(","))
    workers = [int(x) for x in args.workers.split(",") if x] or [
        max(1, (os.cpu_count() or 2) // 2), os.cpu_count() or 2
    ]
    transforms = [t for t in args.transforms.split(",") if t]

    from simseg_tpu_torch.data import native
    from simseg_tpu_torch.data.tokenizer import make_test_vocab

    # the loader runs on the host; the card's line says which machine
    card = print_card(device)
    vocab = make_test_vocab(
        "a synthetic benchmark photo number".split() + ["[unused]"]
    )
    native_ok = native.available()
    if not native_ok:
        print(json.dumps({"decode": "native", "img_per_sec": None,
                          "reason": f"the native library is unavailable: "
                                    f"{native.build_error()}", "card": card}))

    with tempfile.TemporaryDirectory() as root:
        make_shard(root, args.images, w, h)
        results = {}
        for nw in workers:
            for use_native in ([False, True] if native_ok else [False]):
                cfg = build_cfg(root + "/", transforms, args.batch_size, nw,
                                use_native)
                rate = measure(cfg, vocab)
                key = f"{'native' if use_native else 'pil'}_w{nw}"
                results[key] = round(rate, 1)
                print(json.dumps({
                    "decode": "native" if use_native else "pil",
                    "workers": nw, "img_per_sec": round(rate, 1),
                    "transforms": transforms,
                    "src_size": f"{w}x{h}", "card": card,
                }), flush=True)
        print(json.dumps({"summary": results, "card": card}))
    return results


if __name__ == "__main__":
    main()
