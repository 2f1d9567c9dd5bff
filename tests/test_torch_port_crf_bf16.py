"""PyTorch port (simseg_tpu_torch): the CRF kernels' bf16 mode (the TPU
kernels' default ``compute_dtype``) against the JAX package, on the CPU.

- the plain bf16 versions of ``mean_field_fused`` and
  ``seg_decode_tail_fused`` against JAX's Pallas kernels in interpret mode
  with ``compute_dtype=jnp.bfloat16`` (2 images, 3 maps, 64 x 64, stride
  8): masks and predictions equal on >= 99.9% (XLA on the CPU may keep
  intermediates past their bf16 rounding, so equality is not the bar); the
  bf16 plain version nearer JAX's bf16 kernel than the float32 one is;
- the bf16 ``fused`` and ``stream`` CRF lanes against JAX's ``fused``
  (interpret) and ``pallas`` (interpret) lanes in bf16, >= 99.9%;
- the kernel's band tables against the bf16 band matrices JAX builds;
- ``torch.library.opcheck`` of both ops in both dtypes, the fakes' dtypes;
- on a CUDA tensor the bf16 mode reaches its kernel and raises without it
  (no fallback to the plain version).

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_port_kernels.py`` (marker ``cuda``) and
``chip_smoke.py`` phase 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.ops.crf import dense_crf_batched_du as jax_crf_du
from simseg_tpu.ops.crf_fused import _np_constants
from simseg_tpu.ops.crf_fused import mean_field_fused as jax_fused
from simseg_tpu.ops.crf_fused import seg_decode_tail_fused as jax_tail
import simseg_tpu.ops.crf_pallas as jax_crf_pallas
import simseg_tpu.ops.crf_fused as jax_crf_fused
from simseg_tpu_torch.ops import crf_fused
from simseg_tpu_torch.ops.crf import dense_crf_batched_du
from tests.test_torch_port_decode_tail import _CudaLooking

torch.set_num_threads(1)

BAR = 0.999
B, K, H, S = 2, 3, 64, 8


def _case(seed, scale=0.2):
    """Unaries near the decision boundary (where bf16 and float32 part)
    and noisy images."""
    rng = np.random.default_rng(seed)
    du = (rng.normal(size=(B, K, H, H)) * scale
          + np.linspace(-0.1, 0.1, H)[None, None, None, :]).astype(np.float32)
    rgb = rng.integers(0, 255, (B, H, H, 3)).astype(np.uint8)
    return du, rgb


def _agree(a, b):
    return float((np.asarray(a, np.float32) == np.asarray(b, np.float32)).mean())


@pytest.mark.parametrize("seed,scale,ck", [(1, 0.05, 7), (2, 0.2, 7),
                                           (3, 1.0, 0), (4, 0.2, 0)])
def test_plain_bf16_mean_field_matches_jax_kernel(seed, scale, ck):
    du, rgb = _case(seed, scale)
    want = np.asarray(jax_fused(jnp.asarray(du), jnp.asarray(rgb), stride=S,
                                closing_ksize=ck, compute_dtype=jnp.bfloat16,
                                interpret=True)).astype(np.float32)
    got = crf_fused.mean_field_fused_plain(
        torch.from_numpy(du), torch.from_numpy(rgb), stride=S, closing_ksize=ck,
        compute_dtype="bfloat16")
    assert got.dtype == torch.bfloat16 and got.shape == (B, K, H, H)
    f32 = crf_fused.mean_field_fused_plain(
        torch.from_numpy(du), torch.from_numpy(rgb), stride=S, closing_ksize=ck)
    agree, agree32 = _agree(got.float(), want), _agree(f32, want)
    print(f"mean field seed {seed} scale {scale} closing {ck}: bf16 plain "
          f"{agree:.6f}, float32 plain {agree32:.6f} of JAX's bf16 masks")
    assert agree >= BAR, agree
    # the mode is bf16's own function: nearer JAX's bf16 kernel than f32 is
    assert agree > agree32, (agree, agree32)


@pytest.mark.parametrize("seed", [5, 12])
def test_plain_bf16_tail_matches_jax_kernel(seed):
    """On decode-form unaries (smooth maps, min-max normalised, as the
    decode gives the tail), 8 images: pred and best_w equal on >= 99.9% of
    the batch's pixels (a pixel's pred moves when any of its K masks
    flips)."""
    b = 8
    rng = np.random.default_rng(seed)
    grid, factor = 8, 8
    c = rng.normal(size=(b, K, grid + 2, grid + 2))
    c = (c[..., :-2, :-2] + c[..., 1:-1, 1:-1] + c[..., 2:, 2:])[..., :grid, :grid]
    lo, hi = c.min(axis=(-2, -1), keepdims=True), c.max(axis=(-2, -1), keepdims=True)
    p = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
    du_c = (np.log(p + 1e-8) - np.log(1 - p + 1e-8)).astype(np.float32)
    rgb = rng.integers(0, 255, (b, H, H, 3)).astype(np.uint8)
    scores = rng.uniform(0.1, 0.5, (b, K)).astype(np.float32)
    scores[:, 2] = 0.0
    scores[:, 1] = scores[:, 0]        # a tie: the first wins
    idx = rng.integers(1, 20, (b, K)).astype(np.int32)
    jp, jw = jax_tail(jnp.asarray(du_c), jnp.asarray(rgb), jnp.asarray(scores),
                      jnp.asarray(idx), du_factor=factor, stride=S,
                      closing_ksize=7, compute_dtype=jnp.bfloat16,
                      interpret=True)
    pred, best_w = crf_fused.seg_decode_tail_fused_plain(
        torch.from_numpy(du_c), torch.from_numpy(rgb), torch.from_numpy(scores),
        torch.from_numpy(idx), factor, stride=S, closing_ksize=7,
        compute_dtype="bfloat16")
    assert pred.dtype == torch.int32 and best_w.dtype == torch.float32
    agree = min(_agree(pred, jp), _agree(best_w, jw))
    print(f"tail seed {seed}: pred / best_w agreement {agree:.6f}")
    assert agree >= BAR, agree


@pytest.fixture
def interpret_kernels(monkeypatch):
    import functools

    monkeypatch.setattr(jax_crf_pallas, "bilateral_matvec_batched",
                        functools.partial(jax_crf_pallas.bilateral_matvec_batched,
                                          interpret=True))
    monkeypatch.setattr(jax_crf_fused, "mean_field_fused", functools.partial(
        jax_crf_fused.mean_field_fused, interpret=True))


@pytest.mark.parametrize("lane,jax_lane", [("fused", "fused"),
                                           ("stream", "pallas")])
@pytest.mark.parametrize("seed", [7, 8])
def test_bf16_kernel_lanes_match_jax(interpret_kernels, lane, jax_lane, seed):
    """The CRF entry's kernel lanes in bf16 (their plain versions on the
    CPU) against JAX's same lanes in bf16."""
    du, rgb = _case(seed)
    want = np.asarray(jax_crf_du(jnp.asarray(du), jnp.asarray(rgb),
                                 bilateral_stride=S, bilateral_impl=jax_lane,
                                 compute_dtype="bfloat16"))
    got = dense_crf_batched_du(torch.from_numpy(du), torch.from_numpy(rgb),
                               bilateral_stride=S, bilateral_impl=lane,
                               compute_dtype="bfloat16")
    assert got.dtype == torch.int32
    print(f"{lane} lane seed {seed}: {_agree(got, want):.6f}")
    assert _agree(got, want) >= BAR


@pytest.mark.parametrize("h,w,sxy", [(64, 64, 3.0), (48, 80, 2.0), (16, 24, 5.0)])
def test_band_tables_are_jax_bf16_bands(h, w, sxy):
    """wtab[x, t] = bandw[x + t - r, x], htab[y, t] = bandh[y, y + t - r],
    each rounded to bf16 as JAX rounds its bands, 0 off the map."""
    consts = _np_constants(h, w, 8, sxy, 7)
    bandh = np.asarray(jnp.asarray(consts["bandh"], jnp.bfloat16), np.float32)
    bandw = np.asarray(jnp.asarray(consts["bandw"], jnp.bfloat16), np.float32)
    wtab, htab = (crf_fused.to_bf16(t).float().numpy()
                  for t in crf_fused.bf16_tables(h, w, sxy))
    r = wtab.shape[1] // 2
    for x in range(w):
        for t in range(2 * r + 1):
            xp = x + t - r
            assert wtab[x, t] == (bandw[xp, x] if 0 <= xp < w else 0.0)
    for y in range(h):
        for t in range(2 * r + 1):
            yp = y + t - r
            assert htab[y, t] == (bandh[y, yp] if 0 <= yp < h else 0.0)


def _crf_args(dtype, seed=0, b=2, k=3, h=16, w=24):
    g = torch.Generator().manual_seed(seed)
    du = torch.randn((b, k, h, w), generator=g) * 3
    rgb = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
    return (du, rgb, 2, 3.0, 3.0, 40.0, 13.0, 10.0, 4, 7, dtype)


def _tail_args(dtype, seed=1, b=2, k=3, grid=4, factor=4):
    g = torch.Generator().manual_seed(seed)
    du = torch.randn((b, k, grid, grid), generator=g) * 3
    rgb = torch.randint(0, 256, (b, grid * factor, grid * factor, 3),
                        generator=g, dtype=torch.uint8)
    scores = torch.rand((b, k), generator=g)
    cand = torch.randint(1, 20, (b, k), generator=g)
    return (du, rgb, scores, cand, factor, 2, 3.0, 3.0, 40.0, 13.0, 10.0, 4, 7,
            dtype)


@pytest.mark.parametrize("op", ["crf_mean_field", "crf_decode_tail"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opcheck_both_dtypes(op, dtype):
    fn, make = {"crf_mean_field": (crf_fused.crf_mean_field, _crf_args),
                "crf_decode_tail": (crf_fused.crf_decode_tail, _tail_args)}[op]
    args = make(dtype)
    torch.library.opcheck(fn, args)
    out = fn(*args)
    if op == "crf_mean_field":
        assert out.dtype == (torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
    else:
        assert (out[0].dtype, out[1].dtype) == (torch.int32, torch.float32)


def test_unknown_dtype_raises():
    du, rgb = _case(0)
    with pytest.raises(ValueError, match="compute_dtype"):
        crf_fused.mean_field_fused(torch.from_numpy(du), torch.from_numpy(rgb),
                                   compute_dtype="float16")


@pytest.mark.parametrize("entry", ["mean_field", "tail"])
def test_bf16_on_a_cuda_tensor_takes_the_kernel_or_raises(monkeypatch, entry):
    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    def missing():
        raise OSError("lib.so: cannot open shared object file")

    monkeypatch.setattr(crf_fused, "_library", missing)
    monkeypatch.setattr(crf_fused, "mean_field_fused_plain", no_plain)
    monkeypatch.setattr(crf_fused, "seg_decode_tail_fused_plain", no_plain)
    before = (crf_fused.BF16_LAUNCHES, crf_fused.BF16_TAIL_LAUNCHES)
    rgb = torch.zeros(1, 16, 16, 3).as_subclass(_CudaLooking)
    with pytest.raises(OSError, match="cannot open shared object"):
        if entry == "mean_field":
            crf_fused.mean_field_fused(
                torch.zeros(1, 2, 16, 16).as_subclass(_CudaLooking), rgb,
                stride=4, compute_dtype="bfloat16")
        else:
            crf_fused.seg_decode_tail_fused(
                torch.zeros(1, 2, 4, 4).as_subclass(_CudaLooking), rgb,
                torch.ones(1, 2).as_subclass(_CudaLooking),
                torch.zeros(1, 2, dtype=torch.int32).as_subclass(_CudaLooking),
                4, stride=4, compute_dtype="bfloat16")
    assert (crf_fused.BF16_LAUNCHES, crf_fused.BF16_TAIL_LAUNCHES) == before


@pytest.mark.parametrize("crf_backend,op", [
    ("fused", "crf_mean_field"), ("fused_tail", "crf_decode_tail")])
def test_exported_bf16_seg_artifact_is_the_live_call(tmp_path, crf_backend, op):
    """``seg_eval.crf_dtype: bfloat16`` reaches an exported seg artifact:
    its graph holds the kernel's op once, in bf16, and the loaded artifact
    gives the live call's bits."""
    from simseg_tpu_torch import serving
    from simseg_tpu_torch.models.clip import CLIPModel
    from simseg_tpu_torch.utils.collections import AttrDict

    torch.manual_seed(0)
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16, image_k=3)
    cfg = AttrDict()
    cfg.transforms = AttrDict(input_size=32, normalize=AttrDict(
        mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]))
    cfg.seg_eval = AttrDict(crf_backend=crf_backend, crf_dtype="bfloat16")
    rng = np.random.default_rng(0)
    fn = serving.make_seg_infer_fn(
        model, torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)),
        cfg, num_classes=5, top_cls_num=3, device="cpu")
    x = torch.from_numpy(rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8))
    path = str(tmp_path / "seg.pt2")
    serving.save_artifact(path, serving.export_artifact(fn, (x,)))
    nodes = [n for n in torch.export.load(path).graph.nodes
             if n.op == "call_function" and str(n.target).startswith("simseg.")]
    assert [str(n.target) for n in nodes] == [f"simseg.{op}.default"]
    assert "bfloat16" in nodes[0].args or \
        nodes[0].kwargs.get("compute_dtype") == "bfloat16"
    live = fn(x)
    loaded = serving.load_artifact(path)(x)
    live, loaded = (t if isinstance(t, tuple) else (t,) for t in (live, loaded))
    assert len(live) == len(loaded)
    for a, b in zip(live, loaded):
        assert torch.equal(a, b)
