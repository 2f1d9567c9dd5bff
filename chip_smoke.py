"""Build and run the PyTorch/CUDA port (``simseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
1. the card's name and power limit (nvidia-smi); refuses to run without
   CUDA; float32 matmuls must be full float32 (no TF32);
2. builds the four hand-written kernels from ``simseg_tpu_torch/csrc``
   with nvcc, one process per source, all started together;
3. holds the CRF kernel against its plain PyTorch version on the card at
   the main path's shape (16 images, 5 candidate maps, 288 x 288, stride 8,
   unaries in the decode's form: a patch-grid ``du`` upsampled x16):
   mask agreement >= 99.9%, closing composed outside equal to closing
   inside, zero iterations equal to the unary threshold; times both with
   CUDA events, beside the least time the card could take (also at 64
   images, the bench batch);
3b. the attention kernel against its plain version on (16, T, 12, 64) bf16
   at T = 1297 (the 576-px ViT-B pass), 1024 and 1536 (the band's edges)
   and 325 (the 288-px pass, timed for the record): max abs error <= 2e-2,
   mean <= 2e-3; kernel, plain, ``scaled_dot_product_attention`` and bound
   times;
3c. the bilateral kernel against its plain version at 16 images x 5184
   cells (576 px, stride 8), C = 1 (the degree) and 5: max abs error over
   the plain result's largest entry <= 1e-4; kernel, plain and bound times,
   also for one image through the unbatched wrapper;
3d. the attention backward kernel against its plain version on
   (16, T, 12, 64) bf16 at T = 1297, 1024 and 1536, and at (32, 1297, 12,
   64), the shape the training slice gives it; q, k, v and o from the
   forward kernel with its log-sum-exp, random g: per gradient, max abs
   error <= 2e-2 x the plain result's largest entry and mean abs error <=
   1e-2 x its mean abs entry; backward, forward with and without lse, plain
   backward and ``scaled_dot_product_attention`` backward times, and bound;
4. drives the main path: zero-shot segmentation with the ViT-B/16 (288 px)
   and BERT-base towers in bf16, seeded random weights, the 21 PASCAL VOC
   classes, through ``evaluate_benchmark`` on 3 synthetic batches of 16;
   checks that the kernel ran there, that the results are finite and of
   the right shape, and that one batch's predictions agree with the plain
   decode on the card;
4b. the multi-scale slice: the same model through ``evaluate_benchmark``
   with ``scales=(1.0, 2.0)`` on 3 batches of 16; the attention and CRF
   kernels must have run there; on one batch the 2.0-scale tower's dense
   features with kernel attention against plain attention (per-token
   cosine >= 0.999) and the decode's predictions against the plain decode
   on the same features (>= 99.9%); images/s and a device profile;
4c. the sliding-window slice: 576-px images (GT 500 x 500 in VOC's 512
   canvas) through ``evaluate_benchmark`` with 288-px windows at stride
   192: 4 bilateral launches per batch, none of the fused CRF; predictions
   against the plain decode (>= 99.9%); images/s and a device profile;
5. checkpoint loading: the seeded model's state dict at a 224-px grid,
   ``module.``-prefixed, loaded into the 288-px model: every entry
   matched, ``pos_embed`` equal to its bicubic resampling;
6. the training slice: ``tasks/clip/train.train`` with the flagship
   config (``TRAIN_OVERRIDES``, the optim, lr, model, pool, loss and bf16
   sections of ``configs/clip/simseg.vit-b.yaml``) at a 576-px crop
   (T = 1297), batch 32, 12 steps on a loader that repeats one batch of
   synthetic scenes with captions: every loss finite and the last below the
   first; 12 forward and 12 backward attention-kernel launches per step and
   no CRF launch; the checkpoint resumed by a second ``train`` at step 12
   with equal parameters and optimizer state; one step at batch 8 against
   ``flash_train_supported`` patched to False (the forward kernel with the
   plain backward): loss within 1e-2 relative, gradient cosine >= 0.99
   for every image-tower parameter, peak memory of both; ms per step
   (steps 3-12, the host work between steps included), images/s, idle
   share and a device profile; then 12 steps at the YAML's own 224-px crop
   (T = 197), where no attention kernel runs, at batch 32 and at 128.
It then prints one JSON line of kernel numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock
from concurrent.futures import ThreadPoolExecutor

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
HEADS = 12
HEAD_DIM = 64
LONG_T = (2 * SIZE // PATCH) ** 2 + 1   # 1297: the 2.0-scale ViT-B pass
ATTN_TS = (LONG_T, 1024, 1536, (SIZE // PATCH) ** 2 + 1)
WIN_INPUT = 576                          # sliding-window slice
WIN = 288
WIN_STRIDE = 192
GT = 500
KERNELS = ("crf_mean_field", "flash_attention", "flash_attention_bwd",
           "bilateral_matvec")
BWD_TS = (LONG_T, 1024, 1536)
# the sections of configs/clip/simseg.vit-b.yaml that the training slice
# reproduces (no YAML is read on the card; tests/test_torch_port_config.py
# holds this list against the file)
TRAIN_OVERRIDES = (
    "optim.name=torch.optim.AdamW",
    "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.001}",
    "optim.lr.name=cosine_schedule_with_warmup_min_lr_scale",
    "optim.lr.init=1e-4",
    "optim.lr.warmup_proportion=0.025",
    "optim.lr.param={'num_cycles': 0.5, 'min_lr_scale': 0.1}",
    "model.name=clip",
    "model.max_length=25",
    "model.image_encoder.name=vit_modelzoo",
    "model.image_encoder.tag=vit_base_patch16_224_in21k",
    "model.image_encoder.embedding_dim=768",
    "model.image_encoder.pretrained=True",
    "model.image_encoder.trainable=True",
    "model.text_encoder.name=huggingface_modelzoo",
    "model.text_encoder.tag=bert-base-uncased",
    "model.text_encoder.embedding_dim=768",
    "model.text_encoder.pretrained=True",
    "model.text_encoder.trainable=True",
    "model.text_encoder.target_token_idx=0",
    "model.projection.name=simple",
    "model.projection.dim=512",
    "model.pool.name=loda",
    "model.pool.loda.image_k=5",
    "model.pool.loda.text_k=1",
    "loss.name=NCE",
    "loss.global_reduce=True",
    "loss.nce_loss.gather_backward=True",
    "loss.temperature.name=parameter",
    "loss.temperature.value=0.02",
    "dist.bf16=True",
)
TRAIN_SIZE = 576                          # the crop of the training slice
TRAIN_BATCH = 32
TRAIN_STEPS = 12
COMPARE_BATCH = 8
BATCHES_224 = (TRAIN_BATCH, 128)
TRAIN_SLICE = (f"transforms.random_resize_crop.size={TRAIN_SIZE}",
               f"transforms.input_size={TRAIN_SIZE}",
               f"data.batch_size={TRAIN_BATCH}",
               f"data.train_steps={TRAIN_STEPS}", "epoch=1")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor
# FLOP/s, bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


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


def device_profile(fn, label: str, top: int = 8) -> float:
    """Prints the device time of one call of fn, by kernel (torch.profiler);
    returns the total in ms."""
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
    return total / 1e3


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
    # the plain version is a chain of small launches: its event time follows
    # the host, its device time does not
    plain_device = device_profile(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), f"crf plain b={b}", top=0)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    bound, bound_by = crf_bound_ms(b, CLASSES_PER_IMAGE, SIZE, SIZE, STRIDE,
                                   radius, ITERS, rgb.numel() * rgb.element_size())
    print(f"crf b={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device "
          f"{plain_device:.4f} ms), bound {bound:.4f} ms ({bound_by})",
          flush=True)
    device_profile(lambda: crf_fused.mean_field_fused(
        du, rgb, closing_ksize=CLOSING, **kw), f"crf kernel b={b}")
    return dict(max_abs_err=max_err, agreement=agree, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by)


def seeded_clip(seed: int, img_size: int = SIZE):
    """The flagship CLIP model (ViT-B/16, BERT-base, 512-d simple
    projection, LoDA k=5) on the CPU in float32, with weights drawn from a
    seeded generator."""
    from simseg_tpu_torch.models.clip import CLIPModel

    model = CLIPModel(image_tag="vit_base_patch16_224_in21k", img_size=img_size,
                      text_tag="bert-base-uncased", projection_name="simple",
                      projection_dim=512, pool_name="loda", image_k=5,
                      text_k=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def seeded_model(seed: int):
    """``seeded_clip`` at 288 px, in bf16 on the card."""
    return seeded_clip(seed).to(device="cuda", dtype=torch.bfloat16).eval()


class SyntheticLoader:
    """Batches in the JAX loader's contract: uint8 images, labels, GT size.
    Labels are made at the image size and resized (nearest) to ``gt``."""

    def __init__(self, batches, batch_size, num_classes, seed, size=SIZE,
                 gt=None):
        self.batches, self.batch_size = batches, batch_size
        self.num_classes, self.seed = num_classes, seed
        self.size, self.gt = size, gt or size

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        idx = np.arange(self.gt) * self.size // self.gt
        for _ in range(self.batches):
            images, labels = synthetic_scenes(rng, self.batch_size, self.size,
                                              self.num_classes)
            yield {"image": images, "mask_label": labels[:, idx][:, :, idx],
                   "mask_h": [self.gt] * self.batch_size,
                   "mask_w": [self.gt] * self.batch_size}


def counters():
    """Kernel name -> (module, attribute) of its wrapper's launch count."""
    from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention

    return {"crf_mean_field": (crf_fused, "LAUNCHES"),
            "flash_attention": (flash_attention, "LAUNCHES"),
            "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES"),
            "bilateral_matvec": (crf_pallas, "LAUNCHES")}


def reset_counts() -> None:
    for module, attr in counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in counters().items()}


def slice_setup():
    """(model, tokenizer, classes) of the segmentation slices."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    classes = load_label_bank("pascal_voc")
    words = [w for t in IMAGENET_TEMPLATES for w in t.replace("{}", " ")
             .replace(".", " ").split()] + classes
    return seeded_model(0), WordPieceTokenizer(make_test_vocab(words)), classes


def run_slice(model, tokenizer, classes):
    """Phase 4: returns the kernel's launches on the main path."""
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.pooling import l2_normalize
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, decode_tail, shortlist
    from simseg_tpu_torch.tasks.seg_eval import (
        evaluate_benchmark, make_seg_predict, zero_shot_classifier)

    loader = SyntheticLoader(3, BATCH, len(classes), seed=1)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iou, miou = evaluate_benchmark(
        loader, model, tokenizer, classes, top_cls_num=10,
        dataset_name="pascal_voc", input_size=SIZE, max_length=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["crf_mean_field"]
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


def check_flash_kernel(t):
    """Phase 3b at T = t: returns the kernel's JSON fields (no launches)."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn(BATCH, t, HEADS, HEAD_DIM, device="cuda",
                           generator=gen) for _ in range(3))
    q, k, v = (x.to(torch.bfloat16) for x in (q * HEAD_DIM ** -0.5, k, v))
    got = flash_attention.flash_mha(q, k, v)
    want = flash_attention.flash_mha_plain(q, k, v)
    err = (got.float() - want.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    print(f"attention T={t}: kernel vs plain max abs err {max_err:.3e}, "
          f"mean {mean_err:.3e}", flush=True)
    if max_err > 2e-2 or mean_err > 2e-3:
        raise AssertionError(f"attention T={t}: error {max_err} / {mean_err}")
    ms = cuda_ms(lambda: flash_attention.flash_mha(q, k, v), 20)
    plain_ms = cuda_ms(lambda: flash_attention.flash_mha_plain(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=1.0), 20)
    # the work: 4 B H T^2 hd tensor-core operations; q, k, v, o once each
    t_ops = 4 * BATCH * HEADS * t * t * HEAD_DIM / BF16_FLOP_PER_S * 1e3
    t_bytes = 4 * BATCH * t * HEADS * HEAD_DIM * 2 / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"attention T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=sdpa_ms)


def check_flash_bwd_kernel(t, b=BATCH):
    """Phase 3d at (b, t, 12, 64): returns the backward kernel's JSON fields
    (no launches)."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(t + b)
    q, k, v, g = (torch.randn(b, t, HEADS, HEAD_DIM, device="cuda",
                              generator=gen) for _ in range(4))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q * HEAD_DIM ** -0.5, k, v, g))
    out, lse = fa._launch(q, k, v, with_lse=True)
    got = fa.flash_mha_train_bwd(q, k, v, out, g, lse)
    want = fa.flash_mha_train_bwd_plain(q, k, v, g)
    max_err = 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = (x.float() - y.float()).abs()
        ref = y.float().abs()
        e_max, e_mean = err.max().item(), err.mean().item()
        r_max, r_mean = ref.max().item(), ref.mean().item()
        print(f"attention bwd B={b} T={t} {name}: max abs err {e_max:.3e} "
              f"(plain max {r_max:.3e}), mean {e_mean:.3e} (plain mean "
              f"{r_mean:.3e})", flush=True)
        if e_max > 2e-2 * r_max or e_mean > 1e-2 * r_mean:
            raise AssertionError(f"attention bwd B={b} T={t} {name}: error "
                                 f"{e_max} / {e_mean}")
        max_err = max(max_err, e_max)

    ms = cuda_ms(lambda: fa.flash_mha_train_bwd(q, k, v, out, g, lse), 20)
    fwd_lse_ms = cuda_ms(lambda: fa._launch(q, k, v, with_lse=True), 20)
    fwd_ms = cuda_ms(lambda: fa._launch(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fa.flash_mha_train_bwd_plain(q, k, v, g), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

    sdpa_f = cuda_ms(sdpa_fwd, 20)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt), 20)
    # the work: 10 B H T^2 hd tensor-core operations (dv, dp, dq, dk and the
    # recomputed s); q, k, v, o, g and lse read once, dq, dk, dv written once
    t_ops = 10 * b * HEADS * t * t * HEAD_DIM / BF16_FLOP_PER_S * 1e3
    t_bytes = (8 * b * t * HEADS * HEAD_DIM * 2
               + b * HEADS * t * 4) / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"attention bwd B={b} T={t}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"sdpa bwd {sdpa_fb - sdpa_f:.4f} ms (fwd+bwd {sdpa_fb:.4f}, fwd "
          f"{sdpa_f:.4f}), bound {bound:.4f} ms ({bound_by}); forward kernel "
          f"with lse {fwd_lse_ms:.4f} ms, without {fwd_ms:.4f} ms", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=sdpa_fb - sdpa_f)


def bilateral_bound_ms(b, n, used, c):
    """Least time for out = K q over b images of n cells: per pair the
    used-feature dot (2F), |f_i|^2 + |f_j|^2 - 2 dot (3), clamp, scale and
    exp (3), C multiply-adds (2C) on the CUDA cores; features and q read
    once, out written once."""
    t_ops = b * n * n * (2 * used + 6 + 2 * c) / F32_FLOP_PER_S * 1e3
    t_bytes = b * n * (used + 2 * c) * 4 / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_bilateral_kernel():
    """Phase 3c: returns the JSON fields at C = 5 (the per-iteration call);
    prints C = 1 (the degree), C = 5, and C = 5 for one image through the
    unbatched wrapper."""
    from simseg_tpu_torch.ops import crf_pallas
    from simseg_tpu_torch.ops.crf import bilateral_features, cell_colours

    rng = np.random.default_rng(7)
    rgb = torch.from_numpy(synthetic_scenes(rng, BATCH, WIN_INPUT, 21)[0]).cuda()
    feat = bilateral_features(cell_colours(rgb, STRIDE), 40.0, 13.0, STRIDE)
    n, used = feat.shape[1], feat.shape[2]
    fields = {}
    for c in (1, 5):
        q = (np.ones((BATCH, n, 1)) if c == 1
             else rng.uniform(-1.0, 1.0, (BATCH, n, c)))
        q = torch.from_numpy(q.astype(np.float32)).cuda()
        got = crf_pallas.bilateral_matvec_batched(feat, q)
        want = crf_pallas.bilateral_matvec_plain(feat, q)
        max_err = (got - want).abs().max().item()
        rel = max_err / want.abs().max().item()
        print(f"bilateral C={c} N={n}: kernel vs plain max abs err "
              f"{max_err:.3e}, relative {rel:.3e}", flush=True)
        if rel > 1e-4:
            raise AssertionError(f"bilateral C={c}: relative error {rel}")
        ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_batched(feat, q), 20)
        plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(feat, q), 3)
        bound, bound_by = bilateral_bound_ms(BATCH, n, used, c)
        print(f"bilateral C={c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        fields = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=bound_by, library_ms=None)

    # the unbatched entry point (TPU row 3) on one image: the same kernel
    one = crf_pallas.bilateral_matvec(feat[0], q[0])
    if not torch.equal(one, got[0]):
        raise AssertionError("bilateral_matvec != bilateral_matvec_batched[0]")
    ms = cuda_ms(lambda: crf_pallas.bilateral_matvec(feat[0], q[0]), 20)
    plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(
        feat[:1], q[:1]), 3)
    bound, bound_by = bilateral_bound_ms(1, n, used, 5)
    print(f"bilateral one image C=5: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    return fields


def plain_decode(dense, pooled, text_bank, images_u8, size):
    """The decode with every kernel replaced by its plain version: the
    materialised-K mean field and the closing in plain PyTorch."""
    from simseg_tpu_torch.ops.crf import dense_crf_batched_du
    from simseg_tpu_torch.ops.morphology import closing, nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, decode_tail, shortlist

    with torch.no_grad():
        cand_idx, cand_scores, valid = shortlist(pooled, text_bank, 10, 5)
        du = nearest_upsample(coarse_unary(dense, text_bank, cand_idx,
                                           size // PATCH), PATCH).contiguous()
        masks = closing(dense_crf_batched_du(
            du, images_u8, bilateral_stride=STRIDE,
            bilateral_impl="dense").float(), CLOSING)
        return decode_tail(masks, cand_idx, cand_scores, valid)[0]


def drive_eval(label, loader, model, tokenizer, classes, **kw):
    """``evaluate_benchmark`` with the counts set to 0 just before it and
    read just after; returns the counts."""
    from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iou, miou = evaluate_benchmark(
        loader, model, tokenizer, classes, top_cls_num=10,
        dataset_name="pascal_voc", max_length=25, bilateral_stride=STRIDE, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"{label}: evaluate_benchmark on {loader.batches * BATCH} images in "
          f"{wall:.3f} s (text bank included), mIoU {miou:.6f}, launches "
          f"{counts}", flush=True)
    if iou.shape != (len(classes),) or not 0.0 <= miou <= 1.0 or not np.all(
            np.isnan(iou) | ((iou >= 0) & (iou <= 1))):
        raise AssertionError(f"{label}: bad mIoU result {iou} {miou}")
    return counts


def check_decode(label, loader, model, text_bank, classes, size, **kw):
    """One batch: the decode's predictions against the plain decode on the
    same features; then images/s and a device profile of the prediction."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features, make_seg_predict

    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=size, **kw)(images_u8)
    decode = make_seg_decode_fn(num_classes=len(classes), image_size=size,
                                patch_size=PATCH, top_cls_num=10,
                                bilateral_stride=STRIDE)
    with torch.no_grad():
        pred, best_w = decode(dense, pooled, text_bank, images_u8)
    pred_plain = plain_decode(dense, pooled, text_bank, images_u8, size)
    torch.cuda.synchronize()
    if pred.shape != (BATCH, size, size) or not torch.isfinite(best_w).all():
        raise AssertionError(f"{label}: bad decode output {tuple(pred.shape)}")
    if int(pred.min()) < 0 or int(pred.max()) >= len(classes):
        raise AssertionError(f"{label}: class ids out of range")
    agree = (pred == pred_plain).float().mean().item()
    print(f"{label}: pred agreement kernel vs plain decode {agree:.6f}",
          flush=True)
    if agree < 0.999:
        raise AssertionError(f"{label}: pred agreement {agree:.6f} < 0.999")

    predict = make_seg_predict(model, len(classes), 10, input_size=size,
                               bilateral_stride=STRIDE, **kw)
    step_ms = cuda_ms(lambda: predict(images_u8, text_bank), 3)
    device_profile(lambda: predict(images_u8, text_bank),
                   f"{label} towers + decode, batch {BATCH}", top=12)
    print(f"{label}: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s", flush=True)


def run_multiscale_slice(model, tokenizer, classes):
    """Phase 4b: returns the launch counts of its evaluate_benchmark run."""
    import torch.nn.functional as F

    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import flash_attention
    from simseg_tpu_torch.ops.interpolate_pe import resize_bilinear
    from simseg_tpu_torch.tasks.seg_eval import zero_shot_classifier

    scales = (1.0, 2.0)
    loader = SyntheticLoader(3, BATCH, len(classes), seed=2)
    counts = drive_eval("multi-scale", loader, model, tokenizer, classes,
                        input_size=SIZE, scales=scales)
    if counts["flash_attention"] < 1 or counts["crf_mean_field"] < 1:
        raise AssertionError("the multi-scale slice did not run the attention "
                             f"and CRF kernels: {counts}")

    # the 2.0-scale tower with kernel attention against plain attention
    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    big = resize_bilinear(normalize_images(images_u8), 2 * SIZE, 2 * SIZE)

    def dense_tokens():
        with torch.no_grad():
            patches = model.forward_image_tokens(big)[:, 1:]
            return model.project_image_tokens(patches).float()

    before = flash_attention.LAUNCHES
    dense_k = dense_tokens()
    if flash_attention.LAUNCHES - before != 12:
        raise AssertionError("the 576-px tower did not take the kernel in "
                             "each of its 12 layers")
    with unittest.mock.patch.object(flash_attention, "flash_supported",
                                    lambda *a: False):
        dense_p = dense_tokens()
    cos = F.cosine_similarity(dense_k, dense_p, dim=-1).min().item()
    print(f"multi-scale: 576-px tower kernel vs plain attention, min "
          f"per-token cosine {cos:.6f} over {dense_k.shape[1]} tokens",
          flush=True)
    if cos < 0.999:
        raise AssertionError(f"per-token cosine {cos:.6f} < 0.999")

    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    check_decode("multi-scale", loader, model, text_bank, classes, SIZE,
                 scales=scales)
    return counts


def run_window_slice(model, tokenizer, classes):
    """Phase 4c: returns the launch counts of its evaluate_benchmark run."""
    from simseg_tpu_torch.tasks.seg_eval import zero_shot_classifier

    batches = 3
    win = dict(window_size=WIN, window_stride=WIN_STRIDE)
    loader = SyntheticLoader(batches, BATCH, len(classes), seed=3,
                             size=WIN_INPUT, gt=GT)
    counts = drive_eval("window", loader, model, tokenizer, classes,
                        input_size=WIN_INPUT, **win)
    if counts["bilateral_matvec"] != 4 * batches or counts["crf_mean_field"]:
        raise AssertionError("the window slice must launch the bilateral "
                             f"kernel 4 times per batch and no fused CRF: "
                             f"{counts}")
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    check_decode("window", loader, model, text_bank, classes, WIN_INPUT, **win)
    return counts


def check_checkpoint():
    """Phase 5: a 224-px file loaded into the 288-px model."""
    from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
    from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed

    src = seeded_clip(4, img_size=224)
    state = {f"module.{k}": v for k, v in src.state_dict().items()}
    dst = seeded_clip(5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit_b16_224.pth")
        torch.save({"state_dict": state, "meta": {}}, path)
        report = load_clip_checkpoint(path, dst, strict=True)
    buckets = {k: len(v) for k, v in report.items()}
    print(f"checkpoint: 224-px file into the 288-px model: {buckets}",
          flush=True)
    if buckets != {"matched": len(state), "mismatched": 0, "missing": 0,
                   "unexpected": 0}:
        raise AssertionError(f"checkpoint buckets {report}")
    name = "image_encoder.model.model.pos_embed"
    saved = src.state_dict()[name]
    if saved.shape[1] != 197 or not torch.equal(
            dst.state_dict()[name], interpolate_pos_embed(saved, 18 * 18)):
        raise AssertionError("pos_embed is not the resampled one")


def train_cfg(ckpt_dir, *extra):
    """The training slice's config: the default bank, ``TRAIN_OVERRIDES``,
    then ``extra``; no YAML is read."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.clip.config import (task_cfg_init_fn,
                                                    update_clip_config)

    return update_cfg(task_cfg_init_fn, None,
                      list(TRAIN_OVERRIDES) + [f"ckpt.dir={ckpt_dir}",
                                               "log.interval_train=4", *extra],
                      preprocess_fn=update_clip_config, target=new_base_cfg())


def caption_batch(seed, b, size):
    """(batch, tokenizer): b synthetic scenes of ``size`` px as uint8 with
    one caption each, naming the classes of their discs."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank

    classes = load_label_bank("pascal_voc")
    images, labels = synthetic_scenes(np.random.default_rng(seed), b, size,
                                      len(classes))
    captions = []
    for lab in labels:
        names = [classes[c] for c in np.unique(lab) if c > 0]
        captions.append("a photo of " + " and ".join(names or ["nothing"]))
    tok = WordPieceTokenizer(make_test_vocab(
        ["a", "photo", "of", "and", "nothing"] + classes))
    return {"image": images, "caption": captions}, tok


class StepTimer:
    """Wraps ``CLIPRunner.batch_processor``: keeps each step's loss (on the
    device) and CUDA events at the start and end of each step."""

    def __init__(self):
        self.losses, self.events = [], []

    def patch(self):
        from simseg_tpu_torch.core.runner import CLIPRunner

        inner = CLIPRunner.batch_processor

        def wrapped(runner, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(runner, batch)
            end.record()
            self.events.append((start, end))
            self.losses.append(out["loss"])
            return out

        return unittest.mock.patch.object(CLIPRunner, "batch_processor", wrapped)

    def ms_per_step(self, warmup=2):
        """(whole, inside): mean ms per step from the start of step
        ``warmup + 1`` to the end of the last, the hooks, the loader and
        every host stall between steps included; and the mean of the same
        steps' own times, inside ``batch_processor`` only."""
        torch.cuda.synchronize()
        timed = self.events[warmup:]
        whole = timed[0][0].elapsed_time(timed[-1][1]) / len(timed)
        inside = sum(a.elapsed_time(b) for a, b in timed) / len(timed)
        return whole, inside


def step_grads(model, batch):
    """(loss, {name: grad}) of one forward/backward of the train loss."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_train_step(runner, batch):
    """One step's loss and image-tower gradients with the backward kernel
    against ``flash_train_supported`` patched to False; peak memory."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention

    small = {k: v[:COMPARE_BATCH] for k, v in runner._prepare_batch(batch).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = step_grads(runner.model, small)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with unittest.mock.patch.object(flash_attention, "flash_train_supported",
                                    lambda *a: False):
        loss_p, grads_p = step_grads(runner.model, small)
    peak_p = torch.cuda.max_memory_allocated()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    image = [n for n in grads_k if n.startswith("image_encoder.")]
    cos = {n: F.cosine_similarity(grads_k[n].flatten(), grads_p[n].flatten(),
                                  dim=0).item() for n in image}
    worst = min(cos, key=cos.get)
    print(f"train: batch {COMPARE_BATCH} step, backward kernel vs "
          f"flash_train_supported=False: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(relative {rel:.3e}); min gradient cosine {cos[worst]:.6f} "
          f"({worst}) over {len(image)} image-tower tensors; peak memory "
          f"{peak_k / 2**30:.3f} GiB vs {peak_p / 2**30:.3f} GiB", flush=True)
    if rel > 1e-2 or cos[worst] < 0.99:
        raise AssertionError(f"train step kernel vs plain: loss {rel}, "
                             f"cosine {cos[worst]} ({worst})")


def run_train_slice(tmp):
    """Phase 6: returns the launch counts of the 576-px training run."""
    from simseg_tpu_torch.checkpoint.native import has_checkpoint
    from simseg_tpu_torch.tasks.clip.train import train

    cfg = train_cfg(os.path.join(tmp, "ckpt"), *TRAIN_SLICE)
    batch, tok = caption_batch(6, TRAIN_BATCH, TRAIN_SIZE)
    loader = [batch] * TRAIN_STEPS
    timer = StepTimer()
    with timer.patch():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = train(cfg, {"train": [loader]}, tokenizer=tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    losses = [x.item() for x in timer.losses]
    print(f"train: {len(losses)} steps of {TRAIN_BATCH} at {TRAIN_SIZE} px in "
          f"{wall:.3f} s (model build included); losses "
          f"{[round(x, 5) for x in losses]}; launches {counts}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")
    per_step = 12 * TRAIN_STEPS   # the ViT's 12 layers; BERT's T = 25 is plain
    if (counts["flash_attention"] != per_step
            or counts["flash_attention_bwd"] != per_step
            or counts["crf_mean_field"] or counts["bilateral_matvec"]):
        raise AssertionError(f"training launches {counts}, want {per_step} "
                             "forward and backward attention and no CRF")
    if not has_checkpoint(cfg.ckpt.dir):
        raise AssertionError("the training run wrote no checkpoint")

    ms, inside = timer.ms_per_step()
    print(f"train: {ms:.3f} ms per step of {TRAIN_BATCH} at {TRAIN_SIZE} px "
          f"(CUDA events from step 3 to the end of step {TRAIN_STEPS}; "
          f"{inside:.3f} ms inside batch_processor) = "
          f"{TRAIN_BATCH / (ms / 1e3):.1f} images/s", flush=True)

    # a second train() resumes from the checkpoint: step 12, same state
    resumed = train(cfg, {"train": [loader]}, tokenizer=tok)
    same_params = all(torch.equal(a, b) for a, b in zip(
        runner.model.state_dict().values(), resumed.model.state_dict().values()))
    opt_a = runner.optimizer.base.state_dict()["state"]
    opt_b = resumed.optimizer.base.state_dict()["state"]
    same_opt = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
        for i in opt_a for k in opt_a[i])
    print(f"train: resumed at epoch {resumed.epoch}, step {resumed.step}; "
          f"parameters equal {same_params}, optimizer state equal {same_opt}",
          flush=True)
    if resumed.step != TRAIN_STEPS or not (same_params and same_opt):
        raise AssertionError("resume did not restore the trained state")
    del resumed

    compare_train_step(runner, batch)
    device_ms = device_profile(lambda: runner.batch_processor(batch),
                               f"train step, batch {TRAIN_BATCH} at "
                               f"{TRAIN_SIZE} px", top=14)
    print(f"train: device {device_ms:.3f} ms of {ms:.3f} ms per step, idle "
          f"share {1 - device_ms / ms:.3f}", flush=True)
    del runner
    torch.cuda.empty_cache()

    for b in BATCHES_224:
        run_train_224(tmp, tok, b)
    return counts


def run_train_224(tmp, tok, b):
    """12 steps at the YAML's own 224-px crop (model at input_size 288),
    batch b: no attention kernel runs; images/s, idle share and a device
    profile."""
    from simseg_tpu_torch.tasks.clip.train import train

    steps = TRAIN_STEPS
    cfg = train_cfg(os.path.join(tmp, f"ckpt224_{b}"),
                    "transforms.random_resize_crop.size=224",
                    "transforms.input_size=288", f"data.batch_size={b}",
                    f"data.train_steps={steps}", "epoch=1")
    batch, _ = caption_batch(7, b, 224)
    timer = StepTimer()
    with timer.patch():
        reset_counts()
        runner = train(cfg, {"train": [[batch] * steps]}, tokenizer=tok)
        counts = read_counts()
    losses = [x.item() for x in timer.losses]
    ms, inside = timer.ms_per_step()
    print(f"train 224 px batch {b}: losses {[round(x, 5) for x in losses]}; "
          f"{ms:.3f} ms per step (steps 3-{steps}; {inside:.3f} ms inside "
          f"batch_processor) = {b / (ms / 1e3):.1f} images/s; launches "
          f"{counts}", flush=True)
    if (len(losses) != steps or any(counts.values())
            or not all(np.isfinite(losses))):
        raise AssertionError(f"224-px training at batch {b}: launches "
                             f"{counts}, losses {losses}")
    device = device_profile(lambda: runner.batch_processor(batch),
                            f"train step, batch {b} at 224 px", top=10)
    print(f"train 224 px batch {b}: device {device:.3f} ms of {ms:.3f} ms "
          f"per step, idle share {1 - device / ms:.3f}", flush=True)
    del runner
    torch.cuda.empty_cache()


def build_all():
    """Builds the four kernels with one nvcc process each, in parallel."""
    from simseg_tpu_torch.ops import cuda_build

    def build(name):
        t0 = time.perf_counter()
        cuda_build.build_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = list(pool.map(build, KERNELS))
    for name, sec in zip(KERNELS, seconds):
        print(f"build: {name}.cu in {sec:.2f} s", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke needs one")
    import simseg_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must be full float32 (TF32 on)")
    build_all()

    crf = check_crf_kernel(BATCH)
    check_crf_kernel(BENCH_BATCH)
    attn = {t: check_flash_kernel(t) for t in ATTN_TS}
    bilateral = check_bilateral_kernel()
    for t in BWD_TS:
        check_flash_bwd_kernel(t)
    # the training slice's shape: the JSON line's numbers
    attn_bwd = check_flash_bwd_kernel(LONG_T, TRAIN_BATCH)

    model, tokenizer, classes = slice_setup()
    crf_launches = run_slice(model, tokenizer, classes)
    ms_counts = run_multiscale_slice(model, tokenizer, classes)
    win_counts = run_window_slice(model, tokenizer, classes)
    check_checkpoint()
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_counts = run_train_slice(tmp)

    print(json.dumps({"kernels": [
        {"name": "crf_mean_field", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:304",
         "launches": crf_launches, "library_ms": None, **crf},
        {"name": "flash_attention", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:180",
         "launches": ms_counts["flash_attention"], **attn[LONG_T]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:202",
         "launches": train_counts["flash_attention_bwd"], **attn_bwd},
        {"name": "bilateral_matvec", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/bilateral_matvec.cu",
         "replaces": "simseg_tpu/ops/crf_pallas.py:125",
         "launches": win_counts["bilateral_matvec"], **bilateral},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
