"""Build and run the PyTorch/CUDA port (``simseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
1. the card's name and power limit (nvidia-smi); refuses to run without CUDA;
2. builds the hand-written kernel from ``simseg_tpu_torch/csrc`` with nvcc;
3. holds the kernel against its plain PyTorch version on the card at the
   main path's shape (16 images, 5 candidate maps, 288 x 288, stride 8,
   unaries in the decode's form: a patch-grid ``du`` upsampled x16):
   mask agreement >= 99.9%, closing composed outside equal to closing
   inside, zero iterations equal to the unary threshold; times both with
   CUDA events, beside the least time the card could take (also at 64
   images, the bench batch);
4. drives the main path: zero-shot segmentation with the ViT-B/16 (288 px)
   and BERT-base towers in bf16, seeded random weights, the 21 PASCAL VOC
   classes, through ``evaluate_benchmark`` on 3 synthetic batches of 16;
   checks that the kernel ran there, that the results are finite and of
   the right shape, and that one batch's predictions agree with the plain
   decode on the card.
It then prints one JSON line of kernel numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 16
SIZE = 288
PATCH = 16
CLASSES_PER_IMAGE = 5
STRIDE = 8
CLOSING = 7
ITERS = 3
BENCH_BATCH = 64
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, label: str, top: int = 8) -> None:
    """Prints the device time of one call of fn, by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile {label}: {total / 1e3:.4f} ms device time in "
          f"{sum(r[1] for r in rows)} kernel launches", flush=True)
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / total:5.1f}% x{count:<3d} "
              f"{key[:90]}", flush=True)


def crf_bound_ms(b, k, h, w, s, radius, iters, rgb_bytes):
    """Least time for the CRF's work: its inputs read once (du, rgb) and its
    masks written once, over HBM bandwidth; its float32 operations over the
    CUDA cores' peak. Operations: the kernel matrix once (5-d dot, distance,
    exp, row sum), and per class and iteration the box splat, the K.q
    product, the two Gaussian passes and the update."""
    n = (h // s) * (w // s)
    nbytes = 2 * b * k * h * w * 4 + rgb_bytes
    ops = b * (n * n * (2 * 5 + 5)
               + k * iters * (2 * n * n + h * w * (4 * (2 * radius + 1) + 8)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_scenes(rng, b, size, num_classes):
    """Images of a few flat-coloured discs on a background, with noise, and
    their label maps."""
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.empty((b, size, size, 3), np.float32)
    labels = np.zeros((b, size, size), np.uint8)
    for i in range(b):
        images[i] = rng.uniform(0, 255, 3)
        for _ in range(3):
            cy, cx = rng.uniform(0, size, 2)
            r = rng.uniform(size / 8, size / 3)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            images[i][disc] = rng.uniform(0, 255, 3)
            labels[i][disc] = rng.integers(1, num_classes)
    images += rng.normal(0, 6, images.shape)
    return np.clip(images, 0, 255).astype(np.uint8), labels


def decode_form_unary(rng, b, k, grid, factor):
    """(b, k, grid*factor, grid*factor) du from smooth random patch-grid
    similarity maps, min-max normalised, as the decode builds it."""
    from simseg_tpu_torch.ops.morphology import nearest_upsample

    coarse = rng.normal(size=(b, k, grid + 2, grid + 2))
    coarse = (coarse[..., :-2, :-2] + coarse[..., 1:-1, 1:-1]
              + coarse[..., 2:, 2:])[..., :grid, :grid]
    lo = coarse.min(axis=(-2, -1), keepdims=True)
    hi = coarse.max(axis=(-2, -1), keepdims=True)
    p = np.clip((coarse - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
    du = np.log(p + 1e-8) - np.log(1 - p + 1e-8)
    return nearest_upsample(torch.tensor(du, dtype=torch.float32).cuda(),
                            factor).contiguous()


def check_crf_kernel(b):
    """Phase 3 at batch b: returns the kernel's JSON fields (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import closing

    rng = np.random.default_rng(b)
    du = decode_form_unary(rng, b, CLASSES_PER_IMAGE, SIZE // PATCH, PATCH)
    rgb = torch.from_numpy(synthetic_scenes(rng, b, SIZE, 21)[0]).cuda()
    kw = dict(stride=STRIDE, num_iters=ITERS)

    masks = crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)
    plain = crf_fused.mean_field_fused_plain(du, rgb, closing_ksize=CLOSING, **kw)
    torch.cuda.synchronize()
    agree = (masks == plain).float().mean().item()
    max_err = (masks - plain).abs().max().item()
    print(f"crf b={b}: kernel vs plain mask agreement {agree:.6f}, "
          f"max abs err {max_err}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"kernel agrees with plain on {agree:.6f} < 0.999")
    raw = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, **kw)
    if not torch.equal(closing(raw, CLOSING), masks):
        raise AssertionError("closing inside the kernel != closing of its masks")
    zero = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, stride=STRIDE,
                                      num_iters=0)
    if not torch.equal(zero, (du > 0).float()):
        raise AssertionError("zero iterations != unary threshold")

    reps = 20
    ms = cuda_ms(lambda: crf_fused.mean_field_fused(
        du, rgb, closing_ksize=CLOSING, **kw), reps)
    plain_ms = cuda_ms(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), reps // 4)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    bound, bound_by = crf_bound_ms(b, CLASSES_PER_IMAGE, SIZE, SIZE, STRIDE,
                                   radius, ITERS, rgb.numel() * rgb.element_size())
    print(f"crf b={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({bound_by})", flush=True)
    device_profile(lambda: crf_fused.mean_field_fused(
        du, rgb, closing_ksize=CLOSING, **kw), f"crf kernel b={b}")
    return dict(max_abs_err=max_err, agreement=agree, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by)


def seeded_model(seed: int):
    """The flagship CLIP model (ViT-B/16 at 288 px, BERT-base, 512-d simple
    projection, LoDA k=5) with weights drawn from a seeded generator."""
    from simseg_tpu_torch.models.clip import CLIPModel

    model = CLIPModel(image_tag="vit_base_patch16_224_in21k", img_size=SIZE,
                      text_tag="bert-base-uncased", projection_name="simple",
                      projection_dim=512, pool_name="loda", image_k=5,
                      text_k=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=gen)
    return model.to(device="cuda", dtype=torch.bfloat16).eval()


class SyntheticLoader:
    """Batches in the JAX loader's contract: uint8 images, labels, GT size."""

    def __init__(self, batches, batch_size, num_classes, seed):
        self.batches, self.batch_size = batches, batch_size
        self.num_classes, self.seed = num_classes, seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.batches):
            images, labels = synthetic_scenes(rng, self.batch_size, SIZE,
                                              self.num_classes)
            yield {"image": images, "mask_label": labels,
                   "mask_h": [SIZE] * self.batch_size,
                   "mask_w": [SIZE] * self.batch_size}


def run_slice():
    """Phase 4: returns the kernel's launches on the main path."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.pooling import l2_normalize
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, decode_tail, shortlist
    from simseg_tpu_torch.tasks.seg_eval import (
        evaluate_benchmark, load_label_bank, make_seg_predict,
        zero_shot_classifier)
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    classes = load_label_bank("pascal_voc")
    words = [w for t in IMAGENET_TEMPLATES for w in t.replace("{}", " ")
             .replace(".", " ").split()] + classes
    tokenizer = WordPieceTokenizer(make_test_vocab(words))
    model = seeded_model(0)
    loader = SyntheticLoader(3, BATCH, len(classes), seed=1)

    crf_fused.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iou, miou = evaluate_benchmark(
        loader, model, tokenizer, classes, top_cls_num=10,
        dataset_name="pascal_voc", input_size=SIZE, max_length=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = crf_fused.LAUNCHES
    print(f"slice: evaluate_benchmark on {3 * BATCH} images in {wall:.3f} s "
          f"(text bank included), mIoU {miou:.6f}, crf launches {launches}",
          flush=True)
    if launches < 1:
        raise AssertionError("the main path never launched the CRF kernel")
    if iou.shape != (len(classes),) or not 0.0 <= miou <= 1.0 or not np.all(
            np.isnan(iou) | ((iou >= 0) & (iou <= 1))):
        raise AssertionError(f"bad mIoU result {iou} {miou}")

    # one batch: the kernel decode against the plain decode, on the card
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    predict = make_seg_predict(model, len(classes), 10, input_size=SIZE,
                               bilateral_stride=STRIDE)
    pred, best_w = predict(images_u8, text_bank)
    with torch.no_grad():
        patches = model.forward_image_tokens(normalize_images(images_u8))[:, 1:]
        pooled = model.forward_image_project(patches).float()
        dense = l2_normalize(model.project_image_tokens(patches).float())
        cand_idx, cand_scores, valid = shortlist(pooled, text_bank, 10, 5)
        du = nearest_upsample(coarse_unary(dense, text_bank, cand_idx,
                                           SIZE // PATCH), PATCH).contiguous()
        masks = crf_fused.mean_field_fused_plain(
            du, images_u8, stride=STRIDE, closing_ksize=CLOSING)
        pred_plain, _ = decode_tail(masks, cand_idx, cand_scores, valid)
    torch.cuda.synchronize()
    if pred.shape != (BATCH, SIZE, SIZE) or not torch.isfinite(best_w).all():
        raise AssertionError(f"bad decode output {tuple(pred.shape)}")
    if int(pred.min()) < 0 or int(pred.max()) >= len(classes):
        raise AssertionError("class ids out of range")
    agree = (pred == pred_plain).float().mean().item()
    print(f"slice: pred agreement kernel vs plain decode {agree:.6f}; "
          f"valid candidates {int(valid.sum())}/{valid.numel()}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"pred agreement {agree:.6f} < 0.999")

    # steady-state time of the per-batch prediction (towers + decode)
    step_ms = cuda_ms(lambda: predict(images_u8, text_bank), 5)
    device_profile(lambda: predict(images_u8, text_bank),
                   f"towers + decode, batch {BATCH}", top=12)
    print(f"slice: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke needs one")
    from simseg_tpu_torch.ops import crf_fused  # fails outside a checkout

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    crf_fused.build_library()
    print(f"build: crf_mean_field.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)

    fields = check_crf_kernel(BATCH)
    check_crf_kernel(BENCH_BATCH)
    launches = run_slice()

    print(json.dumps({"kernels": [{
        "name": "crf_mean_field",
        "route": "cuda",
        "source": "simseg_tpu_torch/csrc/crf_mean_field.cu",
        "replaces": "simseg_tpu/ops/crf_fused.py:304",
        "launches": launches,
        "library_ms": None,
        **fields,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
