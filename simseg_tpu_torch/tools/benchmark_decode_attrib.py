"""Decode-stage attribution (port of ``tools/benchmark_decode_attrib.py``).

The zero-shot seg decode (``ops/seg_decode.py``) split into parts by
timing ablated variants and differencing, with JAX's lanes and names:

- the full decode at bilateral strides 4, 8, 12, 16 (the kernel's size);
- ``crf_iters`` 0 and 1, ``morphology_ksize=1`` (no closing), both, and
  ``morphology_impl="matmul"``;
- the CRF alone on probability maps in the dense (JAX ``xla``) and stream
  (JAX ``pallas``) lanes; the 7x7 closing alone, window and band products;
- the plain mean field's parts (``MICRO_LANES``) in bf16 at (B, 5, 288,
  288), as JAX's micro-lanes time its TPU lane: on the card the default
  decode runs none of them (the fused kernel does all of it);
- the derived split of the stride-8 decode, only between lines that ran
  the same CRF lane.

Each decode line names the CRF lane it ran, read from the kernels' launch
counters (``fused``: the mean-field kernel; ``stream``: the bilateral
kernel; ``dense``: neither, the plain chain), and its launches a call.

    python -m simseg_tpu_torch.tools.benchmark_decode_attrib [--batch 64]
        [--iters 10] [--trials 3] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.tools.bench_common import (add_device_arg, launches_of,
                                                 print_card, timed_secs)

SIZE = 288
PATCH = 16
CLASSES = 21
DIM = 512
STRIDE = 8                     # the micro-lanes' and the CRF-alone lanes'
CANDIDATES = 5

# JAX :77-85: (name, make_seg_decode_fn keywords)
DECODE_VARIANTS = (
    tuple((f"decode_stride{s}", {"bilateral_stride": s}) for s in (4, 8, 12, 16))
    + (("decode_iters0(build+init)", {"crf_iters": 0}),
       ("decode_iters1", {"crf_iters": 1}),
       ("decode_no_morph", {"morphology_ksize": 1}),
       ("decode_no_crf_no_morph", {"crf_iters": 0, "morphology_ksize": 1}),
       ("decode_closing_matmul", {"morphology_impl": "matmul"})))
# JAX's bilateral impl names -> the port's CRF lanes
CRF_ONLY = (("xla", "dense"), ("pallas", "stream"))
NOTES = {"decode_closing_matmul": "the mean-field kernel runs without its "
                                  "closing; the closing runs as band products "
                                  "after it"}


def crf_lane(launches: dict) -> str:
    """The CRF lane a float32 decode call ran, from its kernel launches."""
    if launches.get("crf_mean_field"):
        return "fused"
    if launches.get("bilateral_matvec"):
        return "stream"
    return "dense"


def decode_inputs(b: int, device, size: int = SIZE):
    """JAX's draws, in its order: dense (B, N, D) and pooled (B, D)
    L2-normalised, the (C, D) text bank, uint8 images, (B, 5, H, W)
    probabilities."""
    from simseg_tpu_torch.ops.pooling import l2_normalize

    rng = np.random.default_rng(0)
    n = (size // PATCH) ** 2
    dense = l2_normalize(torch.from_numpy(
        rng.normal(size=(b, n, DIM)).astype(np.float32)))
    pooled = l2_normalize(torch.from_numpy(
        rng.normal(size=(b, DIM)).astype(np.float32)))
    tb = rng.normal(size=(CLASSES, DIM)).astype(np.float32)
    tb = torch.from_numpy(tb / np.linalg.norm(tb, axis=1, keepdims=True))
    raw = torch.from_numpy(rng.integers(0, 255, (b, size, size, 3)).astype(np.uint8))
    probs = torch.from_numpy(
        rng.uniform(0.0, 1.0, (b, CANDIDATES, size, size)).astype(np.float32))
    return tuple(t.to(device) for t in (dense, pooled, tb, raw, probs))


# -- the plain mean field's parts (JAX :115-196) ------------------------------

def micro_inputs(probs: torch.Tensor, raw: torch.Tensor,
                 dtype=torch.bfloat16) -> dict:
    """The micro-lanes' operands: ``d`` (B, 5, H, W) in ``dtype``, the band
    matrices, the cells' colours and the bilateral kernel matrix."""
    from simseg_tpu_torch.ops.crf import (band_matrix, bilateral_features,
                                          bilateral_kernel_matrix,
                                          cell_colours, gaussian_taps)

    h, stride = probs.shape[-1], STRIDE
    taps = torch.tensor(gaussian_taps(3.0), dtype=torch.float32).to(dtype)
    band = torch.tensor(band_matrix(h, taps.double().numpy()),
                        dtype=dtype, device=probs.device)
    rgb_small = cell_colours(raw, stride)
    kmat = bilateral_kernel_matrix(bilateral_features(rgb_small, 40.0, 13.0,
                                                      stride))
    return {"d": (probs * 2.0 - 1.0).to(dtype), "band": band,
            "rgb_small": rgb_small, "kmat": kmat.to(dtype), "stride": stride}


def gauss_blur_x3(x: dict) -> torch.Tensor:
    from simseg_tpu_torch.ops.crf import _sep_blur

    d = x["d"]
    for _ in range(3):
        d = _sep_blur(d, x["band"], x["band"])
    return d


def blur_w_only_x3(x: dict) -> torch.Tensor:
    from simseg_tpu_torch.ops.crf import _mm

    h = x["d"].shape[-1]
    n = x["d"].reshape(-1, h, h)
    for _ in range(3):
        n = _mm(n, x["band"])
    return n


def blur_h_only_x3(x: dict) -> torch.Tensor:
    from simseg_tpu_torch.ops.crf import _mm

    h = x["d"].shape[-1]
    n = x["d"].reshape(-1, h, h)
    for _ in range(3):
        n = _mm(x["band"].T, n)
    return n


def bilateral_apply_x3(x: dict) -> torch.Tensor:
    from simseg_tpu_torch.ops.crf import _mm, box_downsample
    from simseg_tpu_torch.ops.morphology import nearest_upsample

    d, s = x["d"], x["stride"]
    b, k, h, _ = d.shape
    for _ in range(3):
        small = box_downsample(d, s).reshape(b, k, -1)
        m = _mm(small, x["kmat"].transpose(1, 2))
        d = nearest_upsample(m.reshape(b, k, h // s, h // s), s)
    return d


def kmat_build(x: dict) -> torch.Tensor:
    from simseg_tpu_torch.ops.crf import (bilateral_features,
                                          bilateral_kernel_matrix)

    return bilateral_kernel_matrix(bilateral_features(
        x["rgb_small"], 40.0, 13.0, x["stride"]))


def tanh_combine_x3(x: dict) -> torch.Tensor:
    d = x["d"]
    for _ in range(3):
        d = torch.tanh((d + d) * 0.5)
    return d


MICRO_LANES = (("mf_gauss_blur_x3", gauss_blur_x3),
               ("mf_blur_w_only_x3", blur_w_only_x3),
               ("mf_blur_h_only_x3", blur_h_only_x3),
               ("mf_bilateral_apply_x3", bilateral_apply_x3),
               ("mf_kmat_build", kmat_build),
               ("mf_tanh_combine_x3", tanh_combine_x3))


def derived_split(rows: dict) -> list:
    """JAX's derived split (:198-205) as lines; a difference only between
    two lines that ran the same CRF lane."""
    out = []
    full = rows["decode_stride8"]
    for label, other in (("mean-field 3 iters", "decode_iters0(build+init)"),
                         ("closing (in-situ)", "decode_no_morph")):
        if rows[other]["lane"] != full["lane"]:
            out.append(f"{label:23s} not derived: decode_stride8 ran the "
                       f"{full['lane']} lane, {other} the {rows[other]['lane']}")
            continue
        out.append(f"{label:23s} {full['ms'] - rows[other]['ms']:8.2f}")
        if other == "decode_iters0(build+init)":
            out.append(f"{'kernel build + rest':23s} {rows[other]['ms']:8.2f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch

    from simseg_tpu_torch.ops.crf import dense_crf_batched
    from simseg_tpu_torch.ops.morphology import binary_closing_matmul, closing
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn

    card = print_card(device)
    dense, pooled, tb, raw, probs = decode_inputs(b, device)
    rows = {}

    def add(name, secs, extra=""):
        rows.setdefault(name, {})["ms"] = secs * 1e3
        print(f"{name:34s} {secs * 1e3:8.2f} ms/call {b / secs:9.1f} img/s"
              f"{extra} [{card}]", flush=True)

    def timed(fn, *arrs):
        return timed_secs(fn, arrs, iters=args.iters, trials=args.trials,
                          device=device)

    def time_decode(name, **kw):
        decode = make_seg_decode_fn(CLASSES, SIZE, PATCH, 10, CANDIDATES, **kw)
        launches = launches_of(decode, dense, pooled, tb, raw)
        lane = crf_lane(launches)
        rows[name] = {"lane": lane, "launches": launches}
        note = f"; {NOTES[name]}" if name in NOTES else ""
        add(name, timed(decode, dense, pooled, tb, raw),
            f"  crf lane {lane}, launches a call {launches}{note}")

    for name, kw in DECODE_VARIANTS:
        time_decode(name, **kw)

    for jax_name, lane in CRF_ONLY:
        def crf_fn(p, r, lane=lane):
            return dense_crf_batched(p, r, bilateral_stride=STRIDE,
                                     bilateral_impl=lane)

        name = f"crf_only_{jax_name}"
        launches = launches_of(crf_fn, probs, raw)
        rows[name] = {"lane": crf_lane(launches), "launches": launches}
        add(name, timed(crf_fn, probs, raw),
            f"  crf lane {rows[name]['lane']}, launches a call {launches}")

    # the closing alone, in bf16 (the dtype the decode's closing takes)
    masks = (probs > 0.5).to(torch.bfloat16)
    add("closing7_only", timed(lambda m: closing(m, 7), masks))
    add("closing7_matmul_only", timed(lambda m: binary_closing_matmul(m, 7),
                                      masks))

    print("\n== the plain mean field's parts (bf16, stride 8): the card's "
          "default decode runs none of these; its fused kernel does all of "
          "it ==", flush=True)
    x = micro_inputs(probs, raw)
    for name, body in MICRO_LANES:
        add(name, timed(body, x))

    print(f"\n== derived attribution (stride 8, ms/call) [{card}] ==")
    for line in derived_split(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
