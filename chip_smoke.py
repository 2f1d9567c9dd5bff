"""Build and run the PyTorch/CUDA port (``simseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --attention-trees DIR [DIR ...]   (compare_attention_trees)
    python3 chip_smoke.py --crf-trees DIR [DIR ...]         (compare_crf_trees)
    python3 chip_smoke.py --bilateral-trees DIR [DIR ...]   (compare_bilateral_trees)

Phases (any failure raises, so the exit code is non-zero):
1. the card's name and power limit (nvidia-smi); refuses to run without
   CUDA; float32 matmuls must be full float32 (no TF32);
2. builds the four kernel sources of ``simseg_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
3. holds the CRF kernel against its plain PyTorch version on the card at
   the main path's shape (16 images, 5 candidate maps, 288 x 288, stride 8,
   unaries in the decode's form: a patch-grid ``du`` upsampled x16):
   mask agreement >= 99.9%, closing composed outside equal to closing
   inside, zero iterations equal to the unary threshold, two calls bit-equal;
   three planted faults must fall below the 99.9% bar (the last iteration
   dropped; the image run as two bands of 144 rows that exchange neither
   halo rows nor cells; the bilateral message dropped); times both with
   CUDA events, prints the kernel's device time and CUDA kernels per call
   (profile), beside the least time the card could take and the share of
   it (also at 64 images, the bench batch);
3b. the attention kernel against its plain version on (16, T, 12, 64) bf16
   at T = 1297 (the 576-px ViT-B pass), 1024 and 1536 (the band's edges)
   and 325 (the 288-px pass, timed for the record), with the forward bars
   (relative to the plain output, whose entries shrink as T^-1/2): max abs
   error <= 2e-2 x its largest entry, mean <= 7e-3 x its mean abs entry,
   scale error |1 - <out, plain> / <plain, plain>| <= 3e-5; a second call
   bit-equal to the first; two planted faults must fail the bars (the
   kernel run without its last 128-key tile, and on keys zero-padded to the
   tile, as an unmasked tail would read them); kernel, plain,
   ``scaled_dot_product_attention`` and bound times, the kernel's ratio to
   SDPA and share of its bound; at T = 1297 its device time over 5 calls;
3c. the bilateral kernel against its plain version run in float64 at 16
   images x 5184 cells (576 px, stride 8), C = 1 (the degree) and 5 (q
   the transposed view the CRF's stream lane passes): max abs error over
   the plain result's largest entry <= 1e-5 (the float32 plain version's
   error printed beside it), two calls bit-equal, q as a view equal to q
   contiguous, the unbatched call on one image equal to the batched call's
   image 0; three planted faults must exceed the bar (the plan's last
   column chunk dropped, one feature dropped, the float32 expanded
   distance); kernel (events and device, CUDA kernels per call), float32
   plain and bound times and the share of the bound, also for one image;
3d. the attention backward kernel against its plain version on
   (16, T, 12, 64) bf16 at T = 1297, 1024 and 1536, and at (32, 1297, 12,
   64), the shape the training slice gives it; q, k, v and o from the
   forward kernel with its log-sum-exp, random g: per gradient, max abs
   error <= 2e-2 x the plain result's largest entry, mean abs error <=
   1e-2 x its mean abs entry, scale error |1 - <x, plain> / <plain, plain>|
   <= ``BWD_SCALE``; a second call bit-equal to the first; a planted fault
   must fail the bars (the dk/dv pass without its last q tile: the kernel
   on q, o, g and lse cut to whole 64-row tiles but one, dk and dv against
   the full plain result); backward, forward with and without lse, plain
   backward and ``scaled_dot_product_attention`` backward times, their
   ratio, and bound, and the forward with lse's ratio to SDPA's forward and
   share of its bound; at (32, 1297) the device time of the delta, dq and
   dk/dv passes over five calls;
3e. the long-sequence lanes' forward on (16, T, 12, 64) bf16 at T = 1681,
   2026, 4096 (row-block) and 4097, 5185 (streaming), the lane
   ``attention_lane`` gives each, against that lane's plain version run
   in slices of 2 images (its f32 scores at (16, 5185) would take 20.6 GB):
   the forward bars, determinism check and planted faults of 3b; kernel,
   plain, SDPA and bound times, ratio and share as in 3b; at T = 5185 the
   kernel's device time over 5 calls;
3f. their backward at (16, 1601) (the 640-px training crop, row-block),
   (2, 4097) and (2, 5185) (streaming): the forward kernel's output and
   log-sum-exp into the backward kernel, against the lane's plain forward
   and ``flash_mha_long_bwd_plain``, with the bars, determinism check and
   planted fault of 3d; kernel, plain, SDPA backward and bound times;
3g. the decode-tail kernel at the main path's shape (16 images, 5
   candidates with an invalid one, a negative score and a tie, 288 x 288,
   stride 8, patch-grid unaries in the decode's form): pred and best_w
   each equal to the mean-field kernel + ``decode_tail``'s on >= 99.99% of
   pixels and to its plain version's on >= 99.9% (the counts of differing
   entries printed), two calls bit-equal; kernel (events and device, CUDA
   kernels per call), default-lane, plain and bound times, share of bound;
4. drives the main path: zero-shot segmentation with the ViT-B/16 (288 px)
   and BERT-base towers in bf16, seeded random weights, the 21 PASCAL VOC
   classes, through ``evaluate_benchmark`` on 3 synthetic batches of 16;
   checks that the kernel ran there, that the results are finite and of
   the right shape, and that one batch's predictions agree with the plain
   decode on the card; the CRF kernel's share of a batch's device time
   (also printed for 4b-4e);
4b. the multi-scale slice: the same model through ``evaluate_benchmark``
   with ``scales=(1.0, 2.0)`` on 3 batches of 16; exactly 12 whole-T
   attention launches per batch, no other attention lane, one CRF launch
   per batch; on one batch the 2.0-scale tower's dense
   features with kernel attention against plain attention (per-token
   cosine >= 0.999) and the decode's predictions against the plain decode
   on the same features (>= 99.9%); images/s and a device profile;
4c. the sliding-window slice: 576-px images (GT 500 x 500 in VOC's 512
   canvas) through ``evaluate_benchmark`` with 288-px windows at stride
   192: 4 bilateral launches per batch, none of the fused CRF; predictions
   against the plain decode (>= 99.9%); images/s, a device profile and
   the bilateral kernels' share of a batch (each slice prints the CRF and
   bilateral kernels' shares);
4d. the long multi-scale slice: ``scales=(1.0, 2.5, 4.0)`` at 288 px on 3
   batches of 16: the 720-px view (T = 2026) takes the row-block lane, the
   1152-px view (T = 5185) the streaming lane, 12 calls of each per batch
   and none of the whole-T lanes; on 4 images each long view's dense
   features with kernel against plain attention (per-token cosine >=
   0.999); predictions against the plain decode (>= 99.9%); images/s, idle
   share and a device profile;
4e. the fused-tail slice: ``crf_backend="fused_tail"`` single-scale at
   288 px on 3 batches of 16: one tail launch per batch and no mean-field
   launch; on the same batches predictions against the default lane
   (>= 99.99%) and the plain decode (>= 99.9%); images/s, idle share;
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
   (T = 197), where no attention kernel runs, at batch 32 and at 128
   (finite, falling losses);
6b. training in the row-block band: 12 steps at a 640-px crop (T = 1601,
   where inference would take the plain path), batch 16: 12 row-block
   forward and 12 backward launches per step and no whole-T launch; finite
   losses, the last below the first; one step at batch 4 against the
   same forward kernel with ``flash_mha_long_bwd_plain`` as the backward,
   and against a witness with the image tower's attention in float32:
   loss within 1e-2, image-tower gradient cosine >= 0.99 (the plain bf16
   lane's distance from the witness printed beside); ms per step,
   images/s, idle share.
It then prints one JSON line of kernel numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import shutil
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
           "bilateral_matvec")   # the sources, one library each
BWD_TS = (LONG_T, 1024, 1536)
ROWBLOCK_T = 2026                         # the 720-px view, 2.5 x 288 px
STREAM_T = 5185                           # the 1152-px view, 4.0 x 288 px
LONG_FWD_TS = (1681, ROWBLOCK_T, 4096, 4097, STREAM_T)
ROW_TRAIN_SIZE = 640                      # T = 1601: row-block in training
ROW_TRAIN_BATCH = 16
ROW_COMPARE_BATCH = 4
LONG_BWD = ((ROW_TRAIN_BATCH, (ROW_TRAIN_SIZE // PATCH) ** 2 + 1), (2, 4097),
            (2, STREAM_T))
PLAIN_SLICE = 2                           # images per plain long-attention call
LONG_SCALES = (1.0, 2.5, 4.0)
# attention forward bars, relative to the plain output's largest and mean
# absolute entry (|o| shrinks as T^-1/2, so an absolute bar would not), and
# on the scale error (see attention_errors)
FWD_MAX_REL = 2e-2
FWD_MEAN_REL = 7e-3
FWD_SCALE = 3e-5
FWD_TILE = 128                            # the kernel's k/v tile at hd 64
# attention backward bars, per gradient, relative to the plain result's
# largest and mean absolute entry and on the scale error (see
# attention_errors): the sound kernel's worst scale error over the shapes
# of 3d and 3f is 7.3e-6 (dq at (2, 5185)), the kernel without its last q
# tile reads 2.3e-4 or more; BWD_TILE is the backward's streamed q tile
BWD_MAX_REL = 2e-2
BWD_MEAN_REL = 1e-2
BWD_SCALE = 2e-5
BWD_TILE = 64
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


def device_rows(fn):
    """(device ms, kernel launches, [(us, count, name)] by kernel, largest
    first) of one call of fn, after a warm-up call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows), rows


def launch_times(fn):
    """Device microseconds of each CUDA kernel one call of fn launches, in
    launch order, after a warm-up call (torch.profiler's trace events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return [round(e.time_range.elapsed_us(), 1) for e in
            sorted(kernels, key=lambda e: e.time_range.start)]


def busy_clock(fn, calls=3000) -> str:
    """nvidia-smi's SM clock and power draw read while the card works
    through ``calls`` queued calls of fn."""
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


def device_profile(fn, label: str, top: int = 8) -> float:
    """Prints the device time of one call of fn, by kernel (torch.profiler);
    returns the total in ms."""
    total, launches, rows = device_rows(fn)
    print(f"profile {label}: {total:.4f} ms device time in {launches} kernel "
          "launches", flush=True)
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / 1e3 / total:5.1f}% x{count:<3d} "
              f"{key[:90]}", flush=True)
    return total


def kernel_share(fn, label, names=("crf_kernel", "bilateral_matvec_kernel",
                                   "bilateral_sum_kernel")):
    """Prints the device ms and share of one call of fn of each kernel whose
    name holds one of ``names``."""
    total, _, rows = device_rows(fn)
    parts = []
    for name in names:
        ms = sum(us for us, _, key in rows if name in key) / 1e3
        parts.append(f"{name} {ms:.4f} ms ({100 * ms / total:.1f}%)")
    print(f"{label}: of {total:.4f} ms device time per batch: "
          f"{', '.join(parts)}", flush=True)


def crf_bound_ms(b, k, h, w, s, radius, iters, nbytes):
    """Least time for the CRF's work: ``nbytes``, its inputs read once and
    its outputs written once, over HBM bandwidth; its float32 operations
    over the CUDA cores' peak. Operations: the kernel matrix once (5-d dot,
    distance, exp, row sum), and per class and iteration the box splat, the
    K.q product, the two Gaussian passes and the update."""
    n = (h // s) * (w // s)
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
    """(b, k, grid*factor, grid*factor) du: ``coarse_form_unary`` nearest-
    upsampled, as the decode builds it."""
    from simseg_tpu_torch.ops.morphology import nearest_upsample

    return nearest_upsample(coarse_form_unary(rng, b, k, grid),
                            factor).contiguous()


def coarse_form_unary(rng, b, k, grid):
    """(b, k, grid, grid) patch-grid du on the card from smooth random
    similarity maps, min-max normalised, as the decode builds it."""
    coarse = rng.normal(size=(b, k, grid + 2, grid + 2))
    coarse = (coarse[..., :-2, :-2] + coarse[..., 1:-1, 1:-1]
              + coarse[..., 2:, 2:])[..., :grid, :grid]
    lo = coarse.min(axis=(-2, -1), keepdims=True)
    hi = coarse.max(axis=(-2, -1), keepdims=True)
    p = np.clip((coarse - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
    du = np.log(p + 1e-8) - np.log(1 - p + 1e-8)
    return torch.tensor(du, dtype=torch.float32).cuda()


def crf_inputs(b):
    """Phase 3's inputs at batch b: decode-form unaries and scenes."""
    rng = np.random.default_rng(b)
    du = decode_form_unary(rng, b, CLASSES_PER_IMAGE, SIZE // PATCH, PATCH)
    rgb = torch.from_numpy(synthetic_scenes(rng, b, SIZE, 21)[0]).cuda()
    return du, rgb


def crf_faults(mean_field, du, rgb):
    """Planted faults, as the masks a faulty kernel would give: the last
    iteration dropped; the image cut into two bands of 144 rows that each
    run alone (the Gaussian's halo rows and the other band's cells never
    exchanged); the bilateral message dropped."""
    kw = dict(stride=STRIDE, closing_ksize=CLOSING)
    half = SIZE // 2
    return {
        "last iteration dropped": mean_field(du, rgb, num_iters=ITERS - 1, **kw),
        "bands unexchanged": torch.cat(
            [mean_field(du[:, :, rows].contiguous(), rgb[:, rows].contiguous(),
                        num_iters=ITERS, **kw)
             for rows in (slice(0, half), slice(half, SIZE))], dim=2),
        "bilateral dropped": mean_field(du, rgb, num_iters=ITERS,
                                        bilateral_compat=0.0, **kw)}


def check_faults(label, faults, want, bar):
    """Each planted fault's agreement with want must fall below bar."""
    for name, got in faults.items():
        agree = (got == want).float().mean().item()
        print(f"{label}: planted fault '{name}': agreement {agree:.6f}",
              flush=True)
        if agree >= bar:
            raise AssertionError(f"{label}: the bars pass the planted fault "
                                 f"'{name}' ({agree:.6f} >= {bar})")


def check_crf_kernel(b):
    """Phase 3 at batch b: returns the kernel's JSON fields (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import closing

    du, rgb = crf_inputs(b)
    kw = dict(stride=STRIDE, num_iters=ITERS)

    masks = crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)
    again = crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)
    plain = crf_fused.mean_field_fused_plain(du, rgb, closing_ksize=CLOSING, **kw)
    torch.cuda.synchronize()
    agree = (masks == plain).float().mean().item()
    max_err = (masks - plain).abs().max().item()
    print(f"crf b={b}: kernel vs plain mask agreement {agree:.6f}, "
          f"max abs err {max_err}; two calls bit-equal "
          f"{torch.equal(masks, again)}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"kernel agrees with plain on {agree:.6f} < 0.999")
    if not torch.equal(masks, again):
        raise AssertionError("two kernel calls gave different masks")
    raw = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, **kw)
    if not torch.equal(closing(raw, CLOSING), masks):
        raise AssertionError("closing inside the kernel != closing of its masks")
    zero = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, stride=STRIDE,
                                      num_iters=0)
    if not torch.equal(zero, (du > 0).float()):
        raise AssertionError("zero iterations != unary threshold")
    check_faults(f"crf b={b}", crf_faults(crf_fused.mean_field_fused, du, rgb),
                 plain, 0.999)

    def kernel():
        return crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)

    reps = 20
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), reps // 4)
    # the plain version is a chain of small launches: its event time follows
    # the host, its device time does not
    plain_device = device_profile(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), f"crf plain b={b}", top=0)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    nbytes = 2 * du.numel() * 4 + rgb.numel() * rgb.element_size()
    bound, bound_by = crf_bound_ms(b, CLASSES_PER_IMAGE, SIZE, SIZE, STRIDE,
                                   radius, ITERS, nbytes)
    device, kernels, _ = device_rows(kernel)
    device_profile(kernel, f"crf kernel b={b}")
    print(f"crf b={b}: kernel {ms:.4f} ms (device {device:.4f} ms, {kernels} "
          f"CUDA kernels per call), plain {plain_ms:.4f} ms (device "
          f"{plain_device:.4f} ms), bound {bound:.4f} ms ({bound_by}), share "
          f"of bound {bound / ms:.3f}", flush=True)
    return dict(max_abs_err=max_err, agreement=agree, ms=ms, device_ms=device,
                kernels_per_call=kernels, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


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
            "seg_decode_tail": (crf_fused, "TAIL_LAUNCHES"),
            "flash_attention": (flash_attention, "LAUNCHES"),
            "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES"),
            "bilateral_matvec": (crf_pallas, "LAUNCHES")}


def reset_counts() -> None:
    from simseg_tpu_torch.ops import flash_attention

    for module, attr in counters().values():
        setattr(module, attr, 0)
    for lane in flash_attention.LANE_CALLS:
        flash_attention.LANE_CALLS[lane] = 0


def read_counts() -> dict:
    """The launch counts, and the attention forward's by lane as
    ``lane_<name>``."""
    from simseg_tpu_torch.ops import flash_attention

    counts = {name: getattr(module, attr)
              for name, (module, attr) in counters().items()}
    counts.update({f"lane_{k}": v for k, v in flash_attention.LANE_CALLS.items()})
    return counts


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
    kernel_share(lambda: predict(images_u8, text_bank), "slice")
    print(f"slice: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s", flush=True)
    return launches


def seeded_qkv(seed, b, t, n=3):
    """n (b, t, 12, 64) bf16 tensors on the card, the first (q) pre-scaled."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(b, t, HEADS, HEAD_DIM, device="cuda", generator=gen)
          for _ in range(n)]
    xs[0] = xs[0] * HEAD_DIM ** -0.5
    return [x.to(torch.bfloat16) for x in xs]


def attention_bound_ms(b, t, ops_per_elem, nbytes):
    """Least time for attention work at (b, t, 12, 64): ops_per_elem x B H
    T^2 hd bf16 tensor-core operations over 989 TFLOP/s, or nbytes over
    HBM bandwidth."""
    t_ops = ops_per_elem * b * HEADS * t * t * HEAD_DIM / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lane_functions(lane):
    """(kernel wrapper, its plain forward) of an attention lane."""
    from simseg_tpu_torch.ops import flash_attention as fa

    name = "flash_mha" if lane == "flash" else f"flash_mha_{lane}"
    return getattr(fa, name), getattr(fa, f"{name}_plain")


def long_lane(t, training):
    """The lane ``attention_lane`` gives the ViT-B heads at T = t; it must
    be a long-sequence lane."""
    from simseg_tpu_torch.ops.attention import attention_lane

    lane = attention_lane(BATCH, HEADS, t, t, HEAD_DIM, torch.bfloat16, None,
                          training)
    if lane not in ("rowblock", "stream"):
        raise AssertionError(f"T={t} routes to {lane!r}, not a long lane")
    return lane


def attention_errors(out, want):
    """(max abs error, (max abs error / max |want|, mean abs error /
    mean |want|, |1 - <out, want> / <want, want>|)) of an attention output
    or gradient against its plain version; the last, a scale error, is what
    a systematic fault (a softmax sum off by a few keys, a gradient missing
    a few query rows) leaves when rounding noise hides it from the first
    two."""
    err = (out.float() - want.float()).abs()
    ref = want.float().abs()
    max_err = err.max().item()
    rel = (max_err / ref.max().item(), err.mean().item() / ref.mean().item())
    del err, ref
    o, w = out.double(), want.double()
    scale = abs(1 - (o * w).sum().item() / (w * w).sum().item())
    return max_err, (*rel, scale)


def within_fwd_bars(rel):
    return (rel[0] <= FWD_MAX_REL and rel[1] <= FWD_MEAN_REL
            and rel[2] <= FWD_SCALE)


def within_bwd_bars(rel):
    return (rel[0] <= BWD_MAX_REL and rel[1] <= BWD_MEAN_REL
            and rel[2] <= BWD_SCALE)


def check_flash_kernel(t, lane="flash", profile=False):
    """Phases 3b / 3e at (16, t, 12, 64): returns the JSON fields (no
    launches). The plain version of a long lane runs in slices of 2
    images: its f32 scores at (16, 5185) would take 20.6 GB. With
    ``profile``, the kernel's device time over five calls."""
    import torch.nn.functional as F

    kernel, plain = lane_functions(lane)
    label = "attention" if lane == "flash" else f"attention {lane}"
    q, k, v = seeded_qkv(t, BATCH, t)
    step = BATCH if lane == "flash" else PLAIN_SLICE

    def plain_all():
        return [plain(q[i:i + step], k[i:i + step], v[i:i + step])
                for i in range(0, BATCH, step)]

    want = torch.cat(plain_all())
    got = kernel(q, k, v)
    max_err, rel = attention_errors(got, want)
    print(f"{label} T={t}: kernel vs plain max abs err {max_err:.3e}; "
          f"relative max {rel[0]:.3e}, mean {rel[1]:.3e}, scale {rel[2]:.3e} "
          f"(bars {FWD_MAX_REL:g}, {FWD_MEAN_REL:g}, {FWD_SCALE:g})",
          flush=True)
    if not within_fwd_bars(rel):
        raise AssertionError(f"{label} T={t}: relative error {rel}")
    if not torch.equal(got, kernel(q, k, v)):
        raise AssertionError(f"{label} T={t}: two calls differ")
    print(f"{label} T={t}: a second call gives a bit-equal output", flush=True)
    del got
    # planted faults the bars must reject: a kernel that skips the last k/v
    # tile, and one that leaves the zero-filled keys of a partial tile
    # unmasked (scores 0, values 0)
    cut = (t - 1) // FWD_TILE * FWD_TILE
    faults = {"last k/v tile dropped": (k[:, :cut], v[:, :cut])}
    if t % FWD_TILE:
        pad = (0, 0, 0, 0, 0, FWD_TILE - t % FWD_TILE)
        faults["partial tile unmasked"] = (F.pad(k, pad), F.pad(v, pad))
    for fault, (fk, fv) in faults.items():
        _, f_rel = attention_errors(kernel(q, fk, fv), want)
        print(f"{label} T={t}: planted fault ({fault}): relative max "
              f"{f_rel[0]:.3e}, mean {f_rel[1]:.3e}, scale {f_rel[2]:.3e}",
              flush=True)
        if within_fwd_bars(f_rel):
            raise AssertionError(f"{label} T={t}: the bars pass a kernel "
                                 f"with the fault '{fault}': {f_rel}")
    del want, faults
    if profile:  # five calls: the profiler may miss a window's first kernel
        device_profile(lambda: [kernel(q, k, v) for _ in range(5)],
                       f"{label} B={BATCH} T={t}, over 5 calls", top=3)
    ms = cuda_ms(lambda: kernel(q, k, v), 20)
    plain_ms = cuda_ms(plain_all, 5 if lane == "flash" else 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=1.0), 20)
    # the work: 4 B H T^2 hd tensor-core operations; q, k, v, o once each
    bound, bound_by = attention_bound_ms(
        BATCH, t, 4, 4 * BATCH * t * HEADS * HEAD_DIM * 2)
    print(f"{label} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          f"{'' if step == BATCH else f' ({BATCH // step} calls of {step} images)'}"
          f", sdpa {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
          f"kernel / sdpa {ms / sdpa_ms:.3f}, share of bound {bound / ms:.3f}",
          flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=sdpa_ms)


def check_flash_bwd_kernel(t, b=BATCH, lane="train", profile=False):
    """Phases 3d / 3f at (b, t, 12, 64): returns the backward kernel's JSON
    fields (no launches). q, k, v and the output and log-sum-exp of the
    forward kernel, random g; the whole-T lane's plain backward recomputes
    everything from q, k, v, g, a long lane's runs on its plain forward's
    output and log-sum-exp. Per gradient the backward bars; a second call
    must give bit-equal gradients (no atomics); a planted fault must fail
    the bars: the kernel run without the last (partial) q tile of the
    dk/dv pass, on q, o, g and lse cut to whole tiles but one, its dk and
    dv held against the full plain result. With ``profile``, the device
    time of each pass over five calls."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention as fa

    q, k, v, g = seeded_qkv(t + b, b, t, n=4)
    out, lse = fa._launch(q, k, v, with_lse=True, lane=lane)
    got = fa.flash_mha_train_bwd(q, k, v, out, g, lse)
    if lane == "train":
        def plain():
            return fa.flash_mha_train_bwd_plain(q, k, v, g)
    else:
        p_out, p_lse = lane_functions(lane)[1](q, k, v, with_lse=True)

        def plain():
            return fa.flash_mha_long_bwd_plain(q, k, v, p_out, g, p_lse)
    label = "attention bwd" if lane == "train" else f"attention {lane} bwd"
    bars = f"(bars {BWD_MAX_REL:g}, {BWD_MEAN_REL:g}, {BWD_SCALE:g})"
    want = plain()
    max_err = 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        e_max, rel = attention_errors(x, y)
        print(f"{label} B={b} T={t} {name}: max abs err {e_max:.3e}; "
              f"relative max {rel[0]:.3e}, mean {rel[1]:.3e}, scale "
              f"{rel[2]:.3e} {bars}", flush=True)
        if not within_bwd_bars(rel):
            raise AssertionError(f"{label} B={b} T={t} {name}: relative "
                                 f"error {rel}")
        max_err = max(max_err, e_max)
    again = fa.flash_mha_train_bwd(q, k, v, out, g, lse)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{label} B={b} T={t}: two calls differ")
    print(f"{label} B={b} T={t}: a second call gives bit-equal dq, dk, dv",
          flush=True)
    cut = (t - 1) // BWD_TILE * BWD_TILE
    _, f_dk, f_dv = fa.flash_mha_train_bwd(q[:, :cut], k, v, out[:, :cut],
                                           g[:, :cut], lse[..., :cut])
    for name, x, y in (("dk", f_dk, want[1]), ("dv", f_dv, want[2])):
        _, f_rel = attention_errors(x, y)
        print(f"{label} B={b} T={t}: planted fault (last q tile dropped, "
              f"{t - cut} of {t} rows) {name}: relative max {f_rel[0]:.3e}, "
              f"mean {f_rel[1]:.3e}, scale {f_rel[2]:.3e}", flush=True)
        if within_bwd_bars(f_rel):
            raise AssertionError(f"{label} B={b} T={t}: the bars pass a "
                                 f"kernel without its last q tile: {f_rel}")
    del want, again, f_dk, f_dv

    def kernel():
        return fa.flash_mha_train_bwd(q, k, v, out, g, lse)

    if profile:  # five calls: the profiler may miss a window's first kernel
        device_profile(lambda: [kernel() for _ in range(5)],
                       f"{label} B={b} T={t}, by pass over 5 calls", top=3)
    ms = cuda_ms(kernel, 20)
    fwd_lse_ms = cuda_ms(lambda: fa._launch(q, k, v, with_lse=True), 20)
    fwd_ms = cuda_ms(lambda: fa._launch(q, k, v), 20)
    plain_ms = cuda_ms(plain, 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

    sdpa_f = cuda_ms(sdpa_fwd, 20)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt), 20)
    # the work: 10 B H T^2 hd tensor-core operations (dv, dp, dq, dk and the
    # recomputed s); q, k, v, o, g and lse read once, dq, dk, dv written once
    bound, bound_by = attention_bound_ms(
        b, t, 10, 8 * b * t * HEADS * HEAD_DIM * 2 + b * HEADS * t * 4)
    print(f"{label} B={b} T={t}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"sdpa bwd {sdpa_fb - sdpa_f:.4f} ms (fwd+bwd {sdpa_fb:.4f}, fwd "
          f"{sdpa_f:.4f}), kernel / sdpa bwd {ms / (sdpa_fb - sdpa_f):.3f}, "
          f"bound {bound:.4f} ms ({bound_by}); forward kernel "
          f"with lse {fwd_lse_ms:.4f} ms, without {fwd_ms:.4f} ms, with lse / "
          f"sdpa fwd {fwd_lse_ms / sdpa_f:.3f}, share of the forward's bound "
          f"{attention_bound_ms(b, t, 4, 0)[0] / fwd_lse_ms:.3f}", flush=True)
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


def bilateral_inputs():
    """Phase 3c's inputs: the (16, 5184, 5) features of 576-px synthetic
    scenes at stride 8 (colours over srgb = 13, positions over sxy = 40),
    the ones column (the degree), q at C = 5 uniform in [-1, 1] and the same
    values as the transposed view the CRF's stream lane passes
    (``ops/crf.py``: a (B, C, N) tensor viewed as (B, N, C))."""
    from simseg_tpu_torch.ops.crf import bilateral_features, cell_colours

    rng = np.random.default_rng(7)
    rgb = torch.from_numpy(synthetic_scenes(rng, BATCH, WIN_INPUT, 21)[0]).cuda()
    feat = bilateral_features(cell_colours(rgb, STRIDE), 40.0, 13.0, STRIDE)
    n = feat.shape[1]
    ones = torch.ones((BATCH, n, 1), dtype=torch.float32, device="cuda")
    q5 = torch.from_numpy(rng.uniform(-1.0, 1.0, (BATCH, n, 5)).astype(
        np.float32)).cuda()
    return feat, ones, q5, q5.transpose(1, 2).contiguous().transpose(1, 2)


def bilateral_rel(got, want):
    """max |got - want| / max |want| (want the float64 plain result)."""
    return ((got.double() - want).abs().max() / want.abs().max()).item()


BILATERAL_BAR = 1e-5


def check_bilateral_kernel():
    """Phase 3c: returns the JSON fields at C = 5 (the per-iteration call,
    q the stream lane's transposed view), with C = 1 (the degree) and one
    image through the unbatched wrapper beside it."""
    from simseg_tpu_torch.ops import crf_pallas

    feat, ones, q5, q5t = bilateral_inputs()
    n, used = feat.shape[1], feat.shape[2]
    fields = {}
    for c, q in ((1, ones), (5, q5t)):
        got = crf_pallas.bilateral_matvec_batched(feat, q)
        again = crf_pallas.bilateral_matvec_batched(feat, q)
        want = crf_pallas.bilateral_matvec_plain(feat.double(), q.double())
        max_err = (got.double() - want).abs().max().item()
        rel = bilateral_rel(got, want)
        rel32 = bilateral_rel(crf_pallas.bilateral_matvec_plain(feat, q), want)
        same = torch.equal(got, again)
        print(f"bilateral C={c} N={n}: kernel vs float64 plain max abs err "
              f"{max_err:.3e}, relative {rel:.3e} (float32 plain {rel32:.3e}); "
              f"two calls bit-equal {same}", flush=True)
        if rel > BILATERAL_BAR:
            raise AssertionError(f"bilateral C={c}: relative error {rel}")
        if not same:
            raise AssertionError(f"bilateral C={c}: two calls differ")
        if c == 5:
            if not torch.equal(got, crf_pallas.bilateral_matvec_batched(feat, q5)):
                raise AssertionError("bilateral: q as a view != q contiguous")
            # planted faults, each must exceed the bar: the plan's last
            # column chunk dropped (q zero there), one feature dropped, the
            # float32 expanded distance (the plain version's)
            plan = crf_pallas.launch_plan(BATCH, n, used, c)
            q_cut = q.clone()
            q_cut[:, (plan.chunks - 1) * plan.chunk_cells:] = 0.0
            faults = {
                "last column chunk dropped": crf_pallas.bilateral_matvec_batched(
                    feat, q_cut),
                "one feature dropped": crf_pallas.bilateral_matvec_batched(
                    feat[..., :used - 1], q),
                "float32 expanded distance": crf_pallas.bilateral_matvec_plain(
                    feat, q)}
            for name, bad in faults.items():
                rel_bad = bilateral_rel(bad, want)
                print(f"bilateral C={c}: planted fault '{name}': relative "
                      f"{rel_bad:.3e}", flush=True)
                if rel_bad <= BILATERAL_BAR:
                    raise AssertionError(f"bilateral: the bar passes the planted "
                                         f"fault '{name}' ({rel_bad:.3e})")
            got5 = got

        def kernel():
            return crf_pallas.bilateral_matvec_batched(feat, q)

        ms = cuda_ms(kernel, 20)
        device, kernels, _ = device_rows(kernel)
        plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(feat, q), 3)
        bound, bound_by = bilateral_bound_ms(BATCH, n, used, c)
        print(f"bilateral C={c}: kernel {ms:.4f} ms (device {device:.4f} ms, "
              f"{kernels} CUDA kernels per call), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
              flush=True)
        fields[c] = dict(max_abs_err=max_err, ms=ms, device_ms=device,
                         kernels_per_call=kernels, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         share_of_bound=bound / ms)

    # the unbatched entry point (TPU row 3) on one image: the same kernel,
    # the same sums as the batched call's image 0
    one = crf_pallas.bilateral_matvec(feat[0], q5t[0])
    if not torch.equal(one, got5[0]):
        raise AssertionError("bilateral_matvec != bilateral_matvec_batched[0]")

    def kernel_one():
        return crf_pallas.bilateral_matvec(feat[0], q5t[0])

    ms = cuda_ms(kernel_one, 20)
    device, kernels, _ = device_rows(kernel_one)
    plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(
        feat[:1], q5t[:1]), 3)
    bound, bound_by = bilateral_bound_ms(1, n, used, 5)
    print(f"bilateral one image C=5: kernel {ms:.4f} ms (device {device:.4f} ms, "
          f"{kernels} CUDA kernels per call), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
          flush=True)
    return dict(library_ms=None, **fields[5], c1_ms=fields[1]["ms"],
                c1_device_ms=fields[1]["device_ms"],
                c1_bound_ms=fields[1]["bound_ms"], one_image_ms=ms,
                one_image_device_ms=device, one_image_kernels_per_call=kernels,
                one_image_plain_ms=plain_ms, one_image_bound_ms=bound)


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


def check_decode(label, loader, model, text_bank, classes, size,
                 crf_backend="auto", **kw):
    """One batch: the decode's predictions against the plain decode on the
    same features; then images/s, a device profile of the prediction and
    the idle share."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features, make_seg_predict

    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=size, **kw)(images_u8)
    decode = make_seg_decode_fn(num_classes=len(classes), image_size=size,
                                patch_size=PATCH, top_cls_num=10,
                                bilateral_stride=STRIDE, crf_backend=crf_backend)
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
                               bilateral_stride=STRIDE, crf_backend=crf_backend,
                               **kw)
    step_ms = cuda_ms(lambda: predict(images_u8, text_bank), 3)
    device = device_profile(lambda: predict(images_u8, text_bank),
                            f"{label} towers + decode, batch {BATCH}", top=12)
    kernel_share(lambda: predict(images_u8, text_bank), label)
    print(f"{label}: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s; device {device:.3f} ms, "
          f"idle share {1 - device / step_ms:.3f}", flush=True)


def run_multiscale_slice(label, model, tokenizer, classes, scales, seed,
                         want_lanes, n_images):
    """Phases 4b / 4d: ``evaluate_benchmark`` with ``scales``; the CRF
    kernel must run once per batch and the attention forward exactly
    ``want_lanes`` ({lane: launches}, every other lane 0). Then, on
    n_images of one batch, each extra view's tower with kernel attention
    (one launch per layer) against plain attention (per-token cosine >=
    0.999), and the decode against the plain decode. Returns the launch
    counts of the evaluate_benchmark run."""
    import torch.nn.functional as F

    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import flash_attention
    from simseg_tpu_torch.ops.interpolate_pe import resize_bilinear
    from simseg_tpu_torch.tasks.seg_eval import zero_shot_classifier

    loader = SyntheticLoader(3, BATCH, len(classes), seed=seed)
    counts = drive_eval(label, loader, model, tokenizer, classes,
                        input_size=SIZE, scales=scales)
    lanes = {k[5:]: v for k, v in counts.items() if k.startswith("lane_")}
    if (lanes != {lane: want_lanes.get(lane, 0) for lane in lanes}
            or counts["crf_mean_field"] != loader.batches):
        raise AssertionError(f"{label}: attention lanes {lanes}, want "
                             f"{want_lanes}, and one CRF launch per batch: "
                             f"{counts}")

    def dense_tokens(view):
        with torch.no_grad():
            patches = model.forward_image_tokens(view)[:, 1:]
            return model.project_image_tokens(patches).float()

    images = normalize_images(torch.from_numpy(
        next(iter(loader))["image"][:n_images]).cuda())
    plain_gates = [unittest.mock.patch.object(flash_attention, gate,
                                              lambda *a: False)
                   for gate in ("flash_supported", "flash_rowblock_supported",
                                "flash_stream_supported")]
    for scale in scales:
        if scale == 1.0:
            continue
        size = int(round(SIZE * scale / PATCH)) * PATCH
        view = resize_bilinear(images, size, size)
        before = flash_attention.LAUNCHES
        dense_k = dense_tokens(view)
        if flash_attention.LAUNCHES - before != 12:
            raise AssertionError(f"the {size}-px tower did not take a kernel "
                                 "in each of its 12 layers")
        with contextlib.ExitStack() as stack:
            for gate in plain_gates:
                stack.enter_context(gate)
            dense_p = dense_tokens(view)
        cos = F.cosine_similarity(dense_k, dense_p, dim=-1).min().item()
        print(f"{label}: {size}-px tower (T = {dense_k.shape[1] + 1}) kernel "
              f"vs plain attention, min per-token cosine {cos:.6f} over "
              f"{n_images} images", flush=True)
        if cos < 0.999:
            raise AssertionError(f"{size}-px per-token cosine {cos:.6f} < 0.999")
        del dense_k, dense_p, view
    torch.cuda.empty_cache()

    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    check_decode(label, loader, model, text_bank, classes, SIZE, scales=scales)
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


def compare_train_step(runner, batch, n=COMPARE_BATCH, patch=None,
                       label="flash_train_supported=False"):
    """One step's loss and image-tower gradients at batch n with the
    backward kernel against ``patch`` (default: ``flash_train_supported``
    patched to False, the forward kernel with the plain backward); peak
    memory."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention

    if patch is None:
        patch = unittest.mock.patch.object(
            flash_attention, "flash_train_supported", lambda *a: False)
    small = {k: v[:n] for k, v in runner._prepare_batch(batch).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = step_grads(runner.model, small)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with patch:
        loss_p, grads_p = step_grads(runner.model, small)
    peak_p = torch.cuda.max_memory_allocated()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    image = [n for n in grads_k if n.startswith("image_encoder.")]
    cos = {n: F.cosine_similarity(grads_k[n].flatten(), grads_p[n].flatten(),
                                  dim=0).item() for n in image}
    worst = min(cos, key=cos.get)
    print(f"train: batch {n} step, backward kernel vs {label}: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} "
          f"(relative {rel:.3e}); min gradient cosine {cos[worst]:.6f} "
          f"({worst}) over {len(image)} image-tower tensors; peak memory "
          f"{peak_k / 2**30:.3f} GiB vs {peak_p / 2**30:.3f} GiB", flush=True)
    if rel > 1e-2 or cos[worst] < 0.99:
        raise AssertionError(f"train step kernel vs plain: loss {rel}, "
                             f"cosine {cos[worst]} ({worst})")


def witness_train_step(runner, batch, n):
    """Phase 6b's witness: one step at batch n with the image tower's
    attention in float32 (plain; q, k, v cast up, the output cast back),
    against which the row-block kernel lane and the plain bf16 lane
    (``flash_rowblock_supported`` patched to False) each give their loss,
    ``pos_embed`` gradient cosine and least image-tower gradient cosine.
    The kernel lane's loss must be within 1e-2, and each image-tower
    gradient's cosine >= 0.99 or no more than 0.01 below the plain bf16
    lane's (``pos_embed``'s gradient, a sum over every token of every
    image, is far from the witness under either bf16 lane)."""
    import torch.nn.functional as F

    from simseg_tpu_torch.models import vit
    from simseg_tpu_torch.ops import attention
    from simseg_tpu_torch.ops import flash_attention as fa

    def f32_attention(q, k, v, num_heads, attention_bias=None):
        return attention.multi_head_attention(
            q.float(), k.float(), v.float(), num_heads,
            attention_bias).to(q.dtype)

    small = {k: v[:n] for k, v in runner._prepare_batch(batch).items()}
    with unittest.mock.patch.object(vit, "multi_head_attention", f32_attention):
        loss_w, grads_w = step_grads(runner.model, small)
    image = [k for k in grads_w if k.startswith("image_encoder.")]
    pos = next(k for k in image if k.endswith("pos_embed"))
    lanes = {"plain bf16": unittest.mock.patch.object(
                 fa, "flash_rowblock_supported", lambda *a: False),
             "row-block kernel": contextlib.nullcontext()}
    cos, rel = {}, {}
    for name, ctx in lanes.items():
        with ctx:
            loss, grads = step_grads(runner.model, small)
        rel[name] = abs(loss - loss_w) / abs(loss_w)
        cos[name] = {k: F.cosine_similarity(
            grads[k].flatten(), grads_w[k].flatten(), dim=0).item()
            for k in image}
        worst = min((k for k in image if k != pos), key=cos[name].get)
        print(f"train: batch {n} step, {name} lane vs float32 attention: "
              f"loss {loss:.6f} vs {loss_w:.6f} (relative {rel[name]:.3e}); "
              f"pos_embed gradient cosine {cos[name][pos]:.6f}, norm ratio "
              f"{grads[pos].norm() / grads_w[pos].norm():.4f}; min cosine "
              f"of the others {cos[name][worst]:.6f} ({worst})", flush=True)
    below = {k: c for k, c in cos["row-block kernel"].items()
             if c < min(0.99, cos["plain bf16"][k] - 0.01)}
    if rel["row-block kernel"] > 1e-2 or below:
        raise AssertionError(f"train step kernel vs float32 attention: loss "
                             f"{rel}, cosines below the bar {below}")


def run_train_slice(tmp):
    """Phases 6 and 6b: returns the launch counts of the 576-px and the
    640-px training runs."""
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

    for b in BATCHES_224:   # the YAML's own crop: no attention kernel
        run_train_crop(tmp, tok, 7, 224, b, {}, input_size=288)
    per_step = 12 * TRAIN_STEPS
    row_counts = run_train_crop(
        tmp, tok, 10, ROW_TRAIN_SIZE, ROW_TRAIN_BATCH,
        {"flash_attention": per_step, "flash_attention_bwd": per_step,
         "lane_rowblock": per_step}, compare=True)
    return counts, row_counts


def run_train_crop(tmp, tok, seed, size, b, want, input_size=None,
                   compare=False):
    """Phases 6 (224 px) / 6b: 12 steps at a ``size``-px crop (the model at
    ``input_size``, by default the crop), batch b, on one repeated batch:
    finite losses, the last below the first, exactly the launches ``want``
    ({count: n}, every other count 0); with ``compare``, one step at batch
    4 against the same forward kernel with ``flash_mha_long_bwd_plain`` as
    the backward; images/s, idle share and a device profile. Returns the
    launch counts."""
    from simseg_tpu_torch.ops import flash_attention as fa
    from simseg_tpu_torch.tasks.clip.train import train

    steps = TRAIN_STEPS
    label = f"train {size} px batch {b}"
    cfg = train_cfg(os.path.join(tmp, f"ckpt{size}_{b}"),
                    f"transforms.random_resize_crop.size={size}",
                    f"transforms.input_size={input_size or size}",
                    f"data.batch_size={b}", f"data.train_steps={steps}",
                    "epoch=1")
    batch, _ = caption_batch(seed, b, size)
    timer = StepTimer()
    with timer.patch():
        reset_counts()
        runner = train(cfg, {"train": [[batch] * steps]}, tokenizer=tok)
        counts = read_counts()
    losses = [x.item() for x in timer.losses]
    ms, inside = timer.ms_per_step()
    print(f"{label}: losses {[round(x, 5) for x in losses]}; "
          f"{ms:.3f} ms per step (steps 3-{steps}; {inside:.3f} ms inside "
          f"batch_processor) = {b / (ms / 1e3):.1f} images/s; launches "
          f"{counts}", flush=True)
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]
            or counts != {k: want.get(k, 0) for k in counts}):
        raise AssertionError(f"{label}: launches {counts}, want {want}; "
                             f"losses {losses}")
    if compare:
        # the same forward kernel; the backward kernel against its plain
        # version
        compare_train_step(runner, batch, ROW_COMPARE_BATCH,
                           unittest.mock.patch.object(
                               fa, "flash_mha_train_bwd",
                               fa.flash_mha_long_bwd_plain),
                           "flash_mha_long_bwd_plain")
        witness_train_step(runner, batch, ROW_COMPARE_BATCH)
    device = device_profile(lambda: runner.batch_processor(batch),
                            f"train step, batch {b} at {size} px", top=10)
    print(f"{label}: device {device:.3f} ms of {ms:.3f} ms per step, idle "
          f"share {1 - device / ms:.3f}", flush=True)
    del runner
    torch.cuda.empty_cache()
    return counts


def tail_inputs():
    """Phase 3g's inputs: patch-grid unaries, scenes, scores with an invalid
    candidate, a negative score and a tie, and class ids."""
    b, k = BATCH, CLASSES_PER_IMAGE
    rng = np.random.default_rng(11)
    du_c = coarse_form_unary(rng, b, k, SIZE // PATCH)
    rgb = torch.from_numpy(synthetic_scenes(rng, b, SIZE, 21)[0]).cuda()
    scores = rng.uniform(0.1, 0.5, (b, k)).astype(np.float32)
    scores[:, 4] = 0.0                   # an invalid candidate
    scores[:, 3] = -0.05                 # a negative score
    scores[:, 2] = scores[:, 1]          # a tie
    idx = np.stack([rng.permutation(np.arange(1, 21))[:k] for _ in range(b)])
    return (du_c, rgb, torch.from_numpy(scores).cuda(),
            torch.from_numpy(idx.astype(np.int32)).cuda())


def check_tail_kernel():
    """Phase 3g: returns the tail kernel's JSON fields (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    b, k = BATCH, CLASSES_PER_IMAGE
    du_c, rgb, scores, idx = tail_inputs()
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    ones = torch.ones_like(scores, dtype=torch.bool)

    def tail():
        return crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, PATCH, **kw)

    def lane():
        masks = crf_fused.mean_field_fused(
            nearest_upsample(du_c, PATCH).contiguous(), rgb, **kw)
        return decode_tail(masks, idx, scores, ones)

    def plain():
        return crf_fused.seg_decode_tail_fused_plain(du_c, rgb, scores, idx,
                                                     PATCH, **kw)

    (pred, bw), (p2, w2), (lp, lw), (pp, pw) = tail(), tail(), lane(), plain()
    torch.cuda.synchronize()
    n = pred.numel()
    differ = {"pred": (int((pred != lp).sum()), int((pred != pp).sum())),
              "best_w": (int((bw != lw).sum()), int((bw != pw).sum()))}
    agree_lane = 1 - max(d[0] for d in differ.values()) / n
    agree_plain = 1 - max(d[1] for d in differ.values()) / n
    same = torch.equal(pred, p2) and torch.equal(bw, w2)
    max_err = (bw - pw).abs().max().item()
    print(f"decode tail: of {n} entries, differing from the mean-field "
          f"kernel + decode_tail / from plain: "
          + ", ".join(f"{k} {a} / {p}" for k, (a, p) in differ.items())
          + f"; best_w max abs err vs plain {max_err}; two calls bit-equal "
          f"{same}", flush=True)
    if agree_lane < 0.9999 or agree_plain < 0.999:
        raise AssertionError(f"decode tail: pred and best_w agreement "
                             f"{agree_lane} (kernel lane) / {agree_plain} "
                             f"(plain): {differ}")
    if not same:
        raise AssertionError("decode tail: two calls differ")
    ms = cuda_ms(tail, 20)
    lane_ms = cuda_ms(lane, 20)
    plain_ms = cuda_ms(plain, 5)
    plain_device = device_profile(plain, "decode tail plain", top=0)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    nbytes = (du_c.numel() * 4 + rgb.numel() * rgb.element_size()
              + pred.numel() * 8 + 8 * b * k)
    bound, bound_by = crf_bound_ms(b, k, SIZE, SIZE, STRIDE, radius, ITERS, nbytes)
    device, kernels, _ = device_rows(tail)
    device_profile(tail, "decode tail kernel")
    print(f"decode tail: kernel {ms:.4f} ms (device {device:.4f} ms, {kernels} "
          f"CUDA kernels per call), crf_mean_field + decode_tail {lane_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms (device {plain_device:.4f} ms), bound "
          f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
          flush=True)
    return dict(max_abs_err=max_err, agreement_kernel_lane=agree_lane,
                agreement_plain=agree_plain, ms=ms, device_ms=device,
                kernels_per_call=kernels, default_lane_ms=lane_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def run_fused_tail_slice(model, tokenizer, classes):
    """Phase 4e: returns the launch counts of its evaluate_benchmark run."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features, zero_shot_classifier

    loader = SyntheticLoader(3, BATCH, len(classes), seed=9)
    counts = drive_eval("fused tail", loader, model, tokenizer, classes,
                        input_size=SIZE, crf_backend="fused_tail")
    if counts["seg_decode_tail"] != loader.batches or counts["crf_mean_field"]:
        raise AssertionError("the fused-tail slice must launch the tail kernel "
                             f"once per batch and no mean field: {counts}")

    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    features = make_seg_features(model, input_size=SIZE)
    decode = {backend: make_seg_decode_fn(
        num_classes=len(classes), image_size=SIZE, patch_size=PATCH,
        top_cls_num=10, bilateral_stride=STRIDE, crf_backend=backend)
        for backend in ("fused_tail", "auto")}
    differ = plain_differ = total = 0
    for batch in loader:
        images_u8 = torch.from_numpy(batch["image"]).cuda()
        dense, pooled = features(images_u8)
        with torch.no_grad():
            pred, best_w = decode["fused_tail"](dense, pooled, text_bank, images_u8)
            pred_a, best_a = decode["auto"](dense, pooled, text_bank, images_u8)
        pred_p = plain_decode(dense, pooled, text_bank, images_u8, SIZE)
        if not torch.isfinite(best_w).all() or int(pred.max()) >= len(classes):
            raise AssertionError("fused tail: bad decode output")
        differ += int((pred != pred_a).sum())
        plain_differ += int((pred != pred_p).sum())
        total += pred.numel()
    print(f"fused tail: pred vs the default lane {1 - differ / total:.6f} "
          f"({differ} of {total} pixels differ), vs plain decode "
          f"{1 - plain_differ / total:.6f}", flush=True)
    if differ > 1e-4 * total or plain_differ > 1e-3 * total:
        raise AssertionError(f"fused tail: {differ} / {plain_differ} of {total} "
                             "pixels differ from the default lane / plain")
    check_decode("fused tail", loader, model, text_bank, classes, SIZE,
                 crf_backend="fused_tail")
    return counts


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


FWD_TREE_SHAPES = ((BATCH, LONG_T, False), (BATCH, ROWBLOCK_T, False),
                   (BATCH, STREAM_T, False), (TRAIN_BATCH, LONG_T, True))


def compare_attention_trees(trees) -> None:
    """``python3 chip_smoke.py --attention-trees DIR ...``: the attention
    kernels of each tree (a checkout of this repository, e.g. an earlier
    commit unpacked with ``git archive``), built with nvcc from its own
    ``simseg_tpu_torch/csrc`` and launched through this tree's wrappers
    (the C interfaces are the same), on the same inputs. The forward:
    checked against the plain version at (2, 1297, 12, 64), then timed with
    CUDA events in turns (the trees in order, then in reverse) at
    ``FWD_TREE_SHAPES`` (the last with the log-sum-exp), beside SDPA and
    the bound. The backward at (32, 1297, 12, 64), fed this tree's forward
    output and log-sum-exp: timed the same way, its dq, dk, dv compared bit
    for bit with the first tree's."""
    import ctypes
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import cuda_build
    from simseg_tpu_torch.ops import flash_attention as fa

    out_dir = tempfile.mkdtemp(prefix="attention_trees_")
    getters = {"flash_attention": fa._library, "flash_attention_bwd": fa._bwd_library}

    def build(job):
        """The tree's library, its functions declared by the wrapper's own
        loader (``fa._library`` or ``fa._bwd_library``, uncached)."""
        i, name = job
        csrc = os.path.join(trees[i], "simseg_tpu_torch", "csrc")
        path = os.path.join(out_dir, f"lib{name}{i}.so")
        proc = subprocess.run(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
             "-o", path, os.path.join(csrc, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}/{name}.cu:\n{proc.stderr}")
        return path

    jobs = [(i, name) for name in getters for i in range(len(trees))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(build, jobs))
    libs = {name: [] for name in getters}
    for (_, name), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        with unittest.mock.patch.object(cuda_build, "load_library", lambda _: lib):
            libs[name].append(getters[name].__wrapped__())

    def using(n, fn):
        """fn() with tree n's libraries behind the wrappers."""
        with unittest.mock.patch.object(fa, "_library", lambda: libs["flash_attention"][n]), \
                unittest.mock.patch.object(fa, "_bwd_library",
                                           lambda: libs["flash_attention_bwd"][n]):
            return fn()

    def in_turns(fn):
        times = [[] for _ in trees]
        for n in list(range(len(trees))) + list(reversed(range(len(trees)))):
            times[n].append(using(n, lambda: cuda_ms(fn, 20)))
        return times

    q, k, v = seeded_qkv(LONG_T, 2, LONG_T)
    want = fa.flash_mha_plain(q, k, v)
    for n, tree in enumerate(trees):
        _, rel = attention_errors(using(n, lambda: fa._launch(q, k, v)), want)
        print(f"tree {tree}: forward (2, {LONG_T}) vs plain: relative max "
              f"{rel[0]:.3e}, mean {rel[1]:.3e}, scale {rel[2]:.3e}", flush=True)
        if not within_fwd_bars(rel):
            raise AssertionError(f"tree {tree}: relative error {rel}")
    for b, t, with_lse in FWD_TREE_SHAPES:
        q, k, v = seeded_qkv(t, b, t)
        times = in_turns(lambda: fa._launch(q, k, v, with_lse=with_lse))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0), 20)
        bound = attention_bound_ms(b, t, 4, 4 * b * t * HEADS * HEAD_DIM * 2)[0]
        for tree, ts in zip(trees, times):
            ms = min(ts)
            print(f"tree {tree}: forward ({b}, {t})"
                  f"{' with lse' if with_lse else ''}: {ts[0]:.4f} / {ts[1]:.4f} "
                  f"ms, sdpa {sdpa_ms:.4f}, kernel / sdpa {ms / sdpa_ms:.3f}, "
                  f"share of bound {bound / ms:.3f}", flush=True)
        del q, k, v, qt, kt, vt
    q, k, v, g = seeded_qkv(LONG_T + TRAIN_BATCH, TRAIN_BATCH, LONG_T, n=4)
    out, lse = fa._launch(q, k, v, with_lse=True)

    def backward():
        return fa.flash_mha_train_bwd(q, k, v, out, g, lse)

    first = using(0, backward)
    times = in_turns(backward)
    for n, (tree, ts) in enumerate(zip(trees, times)):
        same = all(torch.equal(x, y) for x, y in zip(using(n, backward), first))
        print(f"tree {tree}: backward ({TRAIN_BATCH}, {LONG_T}): {ts[0]:.4f} / "
              f"{ts[1]:.4f} ms; dq, dk, dv bit-equal to the first tree's: {same}",
              flush=True)
    shutil.rmtree(out_dir)


def tree_modules(trees, source, module, ptxas=False):
    """For each tree (a checkout of this repository, e.g. an earlier commit
    unpacked with ``git archive``): its ``simseg_tpu_torch/csrc/<source>.cu``
    built with nvcc (one process per tree, all started together) and its own
    ``simseg_tpu_torch/ops/<module>.py`` imported with its ``_library``
    serving that build, since the C interface may differ between trees.
    Returns the modules and the directory of the builds (the caller removes
    it); with ptxas, prints each kernel's registers and spills."""
    import ctypes
    import importlib.util
    import re

    from simseg_tpu_torch.ops import cuda_build

    out_dir = tempfile.mkdtemp(prefix=f"{source}_trees_")

    def build(i):
        csrc = os.path.join(trees[i], "simseg_tpu_torch", "csrc")
        path = os.path.join(out_dir, f"lib{source}{i}.so")
        proc = subprocess.run(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
             *(["-Xptxas", "-v"] if ptxas else []), "-o", path,
             os.path.join(csrc, f"{source}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}/{source}.cu:\n"
                               f"{proc.stderr}")
        return path, proc.stderr

    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(build, range(len(trees))))
    mods = []
    for i, (path, log) in enumerate(built):
        if ptxas:
            # "Compiling entry function '<mangled>'" ... "Used R registers";
            # the template arguments of each instance, as ILi5ELi5E
            kernels = re.findall(r"Compiling entry function '(\w+)'.*?"
                                 r"(\d+) bytes spill stores, (\d+) bytes spill "
                                 r"loads.*?Used (\d+) registers", log, re.S)
            print(f"tree {trees[i]}: ptxas (instance: registers, spill "
                  "stores/loads): " + "; ".join(
                      f"{'/'.join(re.findall(r'Li(\d+)E', k)) or k[-24:]}: "
                      f"{regs}, {st}/{ld}" for k, st, ld, regs in kernels),
                  flush=True)
        spec = importlib.util.spec_from_file_location(
            f"{module}_tree{i}",
            os.path.join(trees[i], "simseg_tpu_torch", "ops", f"{module}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = ctypes.CDLL(path)
        err = getattr(lib, f"{source}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        with unittest.mock.patch.object(cuda_build, "load_library", lambda _: lib):
            lib = mod._library.__wrapped__()
        mod._library = lambda lib=lib: lib
        mods.append(mod)
    return mods, out_dir


def in_turns(trees, fn):
    """CUDA-event ms of fn(n) for each tree n, the trees in order and then
    in reverse: [[a, b] per tree]."""
    times = [[] for _ in trees]
    for n in list(range(len(trees))) + list(reversed(range(len(trees)))):
        times[n].append(cuda_ms(lambda: fn(n), 20))
    return times


def compare_crf_trees(trees) -> None:
    """``python3 chip_smoke.py --crf-trees DIR ...``: the CRF kernel of each
    tree (``tree_modules``: its ``csrc/crf_mean_field.cu`` launched through
    its own ``ops/crf_fused.py``), on phase 3's and 3g's inputs at (16, 5,
    288 x 288, stride 8), the mean field also at 64 images: both entry
    points checked against the first tree's plain versions (>= 99.9% of
    masks, of pred and of best_w), then timed with CUDA events in turns
    (the trees in order, then in reverse), with each tree's device time and
    CUDA kernels per call."""
    mods, out_dir = tree_modules(trees, "crf_mean_field", "crf_fused")
    du, rgb = crf_inputs(BATCH)
    du64, rgb64 = crf_inputs(BENCH_BATCH)
    du_c, rgb_t, scores, idx = tail_inputs()
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    calls = {("mean field", BATCH): lambda mod: mod.mean_field_fused(du, rgb, **kw),
             ("mean field", BENCH_BATCH): lambda mod: mod.mean_field_fused(
                 du64, rgb64, **kw),
             ("decode tail", BATCH): lambda mod: mod.seg_decode_tail_fused(
                 du_c, rgb_t, scores, idx, PATCH, **kw)}
    want = dict(zip(calls, (
        (mods[0].mean_field_fused_plain(du, rgb, **kw),),
        (mods[0].mean_field_fused_plain(du64, rgb64, **kw),),
        mods[0].seg_decode_tail_fused_plain(du_c, rgb_t, scores, idx, PATCH,
                                            **kw))))
    for (name, b), call in calls.items():
        shape = f"{name} ({b}, {CLASSES_PER_IMAGE}, {SIZE}, stride {STRIDE})"
        for tree, mod in zip(trees, mods):
            got = call(mod)
            got = got if isinstance(got, tuple) else (got,)
            agree = min((g == w).float().mean().item()
                        for g, w in zip(got, want[name, b]))
            print(f"tree {tree}: {shape} vs plain agreement {agree:.6f}",
                  flush=True)
            if agree < 0.999:
                raise AssertionError(f"tree {tree}: {shape} agreement {agree}")
        times = in_turns(trees, lambda n: call(mods[n]))
        for tree, mod, ts in zip(trees, mods, times):
            device, kernels, _ = device_rows(lambda: call(mod))
            print(f"tree {tree}: {shape}: {ts[0]:.4f} / {ts[1]:.4f} ms, device "
                  f"{device:.4f} ms in {kernels} CUDA kernels per call; us by "
                  f"launch {launch_times(lambda: call(mod))}", flush=True)
    shutil.rmtree(out_dir)


def compare_bilateral_trees(trees) -> None:
    """``python3 chip_smoke.py --bilateral-trees DIR ...``: the bilateral
    kernel of each tree (``tree_modules``: its ``csrc/bilateral_matvec.cu``,
    registers and spills printed, launched through its own
    ``ops/crf_pallas.py``) on phase 3c's inputs at 16 images x 5184 cells:
    C = 1 (the degree), C = 5 with q the stream lane's transposed view and
    contiguous, and C = 5 on one image through the unbatched wrapper. Each
    tree is checked against the float64 plain version (relative error <=
    1e-5) and for two bit-equal calls, then timed with CUDA events in
    turns (the trees in order, then in reverse), with its device time, CUDA
    kernels per call and share of the bound; the SM clock under load is
    read once, on the last tree."""
    from simseg_tpu_torch.ops import crf_pallas

    mods, out_dir = tree_modules(trees, "bilateral_matvec", "crf_pallas",
                                 ptxas=True)
    feat, ones, q5, q5t = bilateral_inputs()
    n, used = feat.shape[1], feat.shape[2]
    print("SM clock, power under load (the last tree, C = 5): "
          f"{busy_clock(lambda: mods[-1].bilateral_matvec_batched(feat, q5t))}",
          flush=True)
    calls = {
        f"C=1 ({BATCH}, {n})": (
            lambda mod: mod.bilateral_matvec_batched(feat, ones),
            (feat, ones), bilateral_bound_ms(BATCH, n, used, 1)[0]),
        f"C=5 ({BATCH}, {n}) q a view": (
            lambda mod: mod.bilateral_matvec_batched(feat, q5t),
            (feat, q5t), bilateral_bound_ms(BATCH, n, used, 5)[0]),
        f"C=5 ({BATCH}, {n}) q contiguous": (
            lambda mod: mod.bilateral_matvec_batched(feat, q5),
            (feat, q5), bilateral_bound_ms(BATCH, n, used, 5)[0]),
        f"C=5 one image (1, {n})": (
            lambda mod: mod.bilateral_matvec(feat[0], q5[0]),
            (feat[:1], q5[:1]), bilateral_bound_ms(1, n, used, 5)[0])}
    for name, (call, (f, q), bound) in calls.items():
        want = crf_pallas.bilateral_matvec_plain(f.double(), q.double())
        for tree, mod in zip(trees, mods):
            got = call(mod).reshape(want.shape)
            rel = bilateral_rel(got, want)
            same = torch.equal(got, call(mod).reshape(want.shape))
            print(f"tree {tree}: {name} vs float64 plain relative {rel:.3e}, "
                  f"two calls bit-equal {same}", flush=True)
            if rel > BILATERAL_BAR or not same:
                raise AssertionError(f"tree {tree}: {name}: relative {rel}, "
                                     f"bit-equal {same}")
        del want
        times = in_turns(trees, lambda i: call(mods[i]))
        for tree, mod, ts in zip(trees, mods, times):
            device, kernels, _ = device_rows(lambda: call(mod))
            print(f"tree {tree}: {name}: {ts[0]:.4f} / {ts[1]:.4f} ms, device "
                  f"{device:.4f} ms in {kernels} CUDA kernels per call, bound "
                  f"{bound:.4f} ms, share of bound {bound / min(ts):.3f}",
                  flush=True)
    shutil.rmtree(out_dir)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke needs one")
    if sys.argv[1:2] == ["--attention-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_attention_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--crf-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_crf_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--bilateral-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_bilateral_trees(sys.argv[2:])
    import simseg_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must be full float32 (TF32 on)")
    build_all()

    crf = check_crf_kernel(BATCH)
    check_crf_kernel(BENCH_BATCH)
    attn = {t: check_flash_kernel(t, profile=t == LONG_T) for t in ATTN_TS}
    bilateral = check_bilateral_kernel()
    for t in BWD_TS:
        check_flash_bwd_kernel(t)
    # the training slice's shape: the JSON line's numbers
    attn_bwd = check_flash_bwd_kernel(LONG_T, TRAIN_BATCH, profile=True)
    fwd = {t: check_flash_kernel(t, long_lane(t, False), profile=t == STREAM_T)
           for t in LONG_FWD_TS}
    bwd = {(b, t): check_flash_bwd_kernel(t, b, long_lane(t, True))
           for b, t in LONG_BWD}
    # the JSON line's numbers: each lane at its slice's shape
    long_fwd = {"rowblock": fwd[ROWBLOCK_T], "stream": fwd[STREAM_T]}
    long_bwd = {lane: {"bwd_shape": [b, t, HEADS, HEAD_DIM],
                       **{f"bwd_{k}": v for k, v in bwd[b, t].items()
                          if k != "bound_by"}}
                for lane, (b, t) in (("rowblock", LONG_BWD[0]),
                                     ("stream", LONG_BWD[-1]))}
    torch.cuda.empty_cache()
    tail = check_tail_kernel()

    model, tokenizer, classes = slice_setup()
    crf_launches = run_slice(model, tokenizer, classes)
    ms_counts = run_multiscale_slice("multi-scale", model, tokenizer, classes,
                                     (1.0, 2.0), 2, {"flash": 36}, BATCH)
    win_counts = run_window_slice(model, tokenizer, classes)
    # 4 images: the plain 1152-px tower holds (4, 12, 5185, 5185) bf16
    # scores, 2.6 GB, several times over
    long_counts = run_multiscale_slice(
        "long multi-scale", model, tokenizer, classes, LONG_SCALES, 8,
        {"rowblock": 36, "stream": 36}, 4)
    tail_counts = run_fused_tail_slice(model, tokenizer, classes)
    check_checkpoint()
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, row_train_counts = run_train_slice(tmp)

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
        {"name": "seg_decode_tail", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:425",
         "launches": tail_counts["seg_decode_tail"], **tail},
        {"name": "flash_attention (rowblock)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:789",
         "launches": long_counts["lane_rowblock"],
         "train_launches": row_train_counts["lane_rowblock"],
         "bwd_launches": row_train_counts["flash_attention_bwd"],
         "shape": [BATCH, ROWBLOCK_T, HEADS, HEAD_DIM],
         **long_fwd["rowblock"], **long_bwd["rowblock"]},
        {"name": "flash_attention (stream)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:536",
         "launches": long_counts["lane_stream"],
         "shape": [BATCH, STREAM_T, HEADS, HEAD_DIM],
         **long_fwd["stream"], **long_bwd["stream"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
