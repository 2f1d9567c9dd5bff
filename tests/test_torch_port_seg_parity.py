"""PyTorch port (simseg_tpu_torch): the production-settings parity harness
(``simseg_tpu_torch/tools/{seg_parity,parity_reference}.py``) against JAX's
``tools/seg_parity.py`` on the CPU.

- The reference side's pieces bit-equal to JAX's on seeded inputs: the
  exact palette CRF (and JAX's brute-force check of it), its per-image
  state, ``render_scene``, ``class_palette``, ``candidate_decision``, the
  towers of ``tests/torch_reference.py`` under one state dict; the numpy
  closing and nearest resize bit-equal to OpenCV's, odd sizes and borders
  included.
- ``build_fixture`` on 2 aligned scenes at 288 px: the same PNG bytes,
  ``val.txt`` and ``.pth`` tensors as JAX's, the same draw count.
- ``run_parity(device="cpu")`` against JAX's ``_run_parity`` on one fixture
  at 96 px (JAX's flax side takes about a minute at 288 px on two
  threads): the port's reference result equal to the one JAX's run
  computes from its own loader's batches, the same candidate sets, pixel
  disagreement within ``PIXEL_TOL`` and the mIoU delta within ``MIOU_TOL``.
- ``main()``: JAX's keys, JAX's aggregate on the same runs, the empty-noflip
  aggregate JAX's raises on, the refusal without a card, and no ``jax`` or
  ``cv2`` in a process that ran it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tools.seg_parity as jax_parity
from simseg_tpu_torch.tools import parity_reference as ref
from simseg_tpu_torch.tools import seg_parity
from tests.test_crf_morphology import np_dense_crf
from tests.torch_reference import TorchTinyCLIP as JaxTinyCLIP
from tests.torch_reference import torch_topk_pool as jax_topk_pool

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Both sides run bf16 towers and a bf16 CRF on the CPU, JAX through XLA and
# the port through PyTorch, whose bf16 products round in another order: the
# bf16 decode bars of test_torch_port_seg_cli.py (mIoU 1e-2) and of
# test_torch_port_decode_lanes.py. Against the reference the two sides'
# disagreements then differ by no more than these.
PIXEL_TOL = 5e-3
MIOU_TOL = 1e-2


def palette_image(rng, h, w):
    """A two-region palette image with dithered shades and a noisy
    foreground probability (JAX's brute-force case)."""
    pal = np.array([[200, 60, 50], [182, 42, 32], [214, 74, 64],
                    [40, 60, 210], [22, 42, 192], [54, 74, 224]], np.float64)
    idx = (np.where(np.arange(w)[None, :] < w // 2, 0, 3)
           + rng.integers(0, 3, (h, w)))
    probs = np.clip(
        0.5 + 0.35 * np.where(np.arange(w) < w // 2, 1.0, -1.0)[None, :]
        + rng.normal(0, 0.15, (h, w)), 0.01, 0.99)
    return probs, pal[idx]


@pytest.mark.parametrize("seed,h,w", [(0, 20, 20), (1, 17, 23), (2, 24, 13)])
def test_exact_palette_crf_matches_jax_and_brute_force(seed, h, w):
    probs, rgb = palette_image(np.random.default_rng(seed), h, w)
    want = jax_parity.exact_dense_crf_palette(probs, rgb)
    np.testing.assert_array_equal(ref.exact_dense_crf_palette(probs, rgb), want)
    np.testing.assert_array_equal(want, np_dense_crf(probs, rgb))
    state, jstate = ref.crf_image_state(rgb), jax_parity.crf_image_state(rgb)
    for key in ("ng", "nb", "g_total", "b_total"):
        np.testing.assert_array_equal(state[key], jstate[key])
    np.testing.assert_array_equal(
        ref.exact_dense_crf_palette(probs, rgb, _shared=state), want)


@pytest.mark.parametrize("seed,size,gt", [(3, 96, (120, 140)), (4, 288, (375, 500)),
                                          (5, 64, (333, 321))])
def test_render_scene_and_palette_match_jax(seed, size, gt):
    img, label = ref.render_scene(np.random.default_rng(seed), size, gt, 12)
    jimg, jlabel = jax_parity.render_scene(np.random.default_rng(seed), size,
                                           gt, 12)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(label, jlabel)
    for cls in range(30):
        np.testing.assert_array_equal(ref.class_palette(cls),
                                      jax_parity.class_palette(cls))


def test_candidate_decision_matches_jax():
    rng = np.random.default_rng(0)
    cases = [
        # class 3 clearly above, 5 marginal, the rest below: a break
        np.array([0.90, 0.10, 0.12, 0.80, 0.11, 0.50, 0.13, 0.09]),
        # background first (skipped), a tie across the threshold
        np.array([0.99, 0.7, 0.7, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]),
        # everything equal: no candidate
        np.full(16, 0.25),
    ] + [rng.normal(0, 1, n) for n in (2, 8, 16, 21, 40) for _ in range(20)]
    cases += [np.round(rng.normal(0, 1, 16), 1) for _ in range(20)]  # ties
    for scores in cases:
        for top in (3, 10, 30):
            got = ref.candidate_decision(scores, len(scores), top)
            want = jax_parity.candidate_decision(scores, len(scores), top)
            assert got == want, (scores, top)
    assert ref.candidate_decision(cases[0], 8, 10)[0] == [3]


def test_closing_and_nearest_resize_match_opencv():
    import cv2

    rng = np.random.default_rng(0)
    kernel = np.ones((7, 7), np.uint8)
    shapes = [(1, 1), (3, 5), (7, 7), (8, 9), (13, 6), (31, 47), (288, 288)]
    shapes += [tuple(int(v) for v in rng.integers(1, 70, 2)) for _ in range(40)]
    for h, w in shapes:
        for m in ((rng.random((h, w)) < rng.random()).astype(np.uint8) * 255,
                  rng.integers(0, 256, (h, w)).astype(np.uint8)):
            np.testing.assert_array_equal(
                ref.closing(m), cv2.erode(cv2.dilate(m, kernel), kernel))
    # nearest: every GT side the fixtures draw (320-511) and odd ones, up and
    # down, from the decode's 288 and from odd sources
    for h, w in ((288, 288), (13, 29), (97, 5)):
        m = rng.integers(0, 256, (h, w)).astype(np.uint8)
        for out in list(range(1, 40)) + list(range(280, 600)):
            np.testing.assert_array_equal(
                ref.resize_nearest(m, out, h), cv2.resize(
                    m, (out, h), interpolation=cv2.INTER_NEAREST))
            np.testing.assert_array_equal(
                ref.resize_nearest(m, w, out), cv2.resize(
                    m, (w, out), interpolation=cv2.INTER_NEAREST))


def test_tiny_clip_towers_match_the_reference_fixture():
    kwargs = dict(proj_dim=24, vit_kwargs=dict(img_size=32, patch=8, dim=32,
                                               depth=2, heads=2),
                  bert_kwargs=dict(vocab=64, dim=32, depth=2, heads=2,
                                   inter=48, max_pos=16))
    torch.manual_seed(7)
    model = ref.TorchTinyCLIP(**kwargs)
    torch.manual_seed(7)
    jmodel = JaxTinyCLIP(**kwargs)
    state = model.state_dict()
    assert list(state) == list(jmodel.state_dict())
    for k, v in jmodel.state_dict().items():
        assert torch.equal(state[k], v), k
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    jmodel.load_state_dict(model.state_dict())
    images = torch.randn(2, 3, 32, 32)
    ids = torch.randint(0, 64, (3, 9))
    mask = torch.ones(3, 9, dtype=torch.long)
    mask[1, 5:] = 0
    with torch.no_grad():
        assert torch.equal(model.image_encoder.model.model(images),
                           jmodel.image_encoder.model.model(images))
        tokens = model.text_encoder.model(ids, mask)
        assert torch.equal(tokens, jmodel.text_encoder.model(ids, mask))
        assert torch.equal(ref.torch_topk_pool(tokens, 3, mask),
                           jax_topk_pool(tokens, 3, mask))


def fixture_files(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = path
    return out


def test_build_fixture_matches_jax(tmp_path):
    """2 aligned scenes at 288 px, screened at 0.0015: the same files."""
    roots = tmp_path / "port", tmp_path / "jax"
    for r in roots:
        r.mkdir()
    classes, _, ckpt, tried = seg_parity.build_fixture(
        str(roots[0]), 2, 16, 0, 288, screen_margin=0.0015, fixture="aligned")
    jclasses, _, jckpt = jax_parity.build_fixture(
        str(roots[1]), 2, 16, 0, 288, screen_margin=0.0015, fixture="aligned")
    assert classes == jclasses and tried == jax_parity.build_fixture.last_tries
    files, jfiles = fixture_files(roots[0]), fixture_files(roots[1])
    assert sorted(files) == sorted(jfiles)
    assert len([f for f in files if f.endswith(".jpg")]) == 2
    for rel, path in files.items():
        if rel.endswith(".pth"):
            state = torch.load(path, weights_only=True)["state_dict"]
            jstate = torch.load(jfiles[rel], weights_only=True)["state_dict"]
            assert list(state) == list(jstate)
            for k in jstate:
                assert torch.equal(state[k], jstate[k]), k
        else:
            with open(path, "rb") as f, open(jfiles[rel], "rb") as g:
                assert f.read() == g.read(), rel
    assert os.path.basename(ckpt) == os.path.basename(jckpt)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """One aligned fixture at 96 px (2 scenes, 8 classes), the port's
    reference on it, and JAX's ``_run_parity`` on the same root with JAX's
    fixture build replaced by it (same files, as the test above holds) and
    its reference run recorded."""
    root = str(tmp_path_factory.mktemp("small"))
    classes, tmodel, ckpt, tried = seg_parity.build_fixture(
        root, 2, 8, 0, 96, screen_margin=1e-4, fixture="aligned")
    reference = seg_parity.reference_side(root, classes, tmodel, tried)
    recorded = {}
    jax_eval = jax_parity.torch_production_eval

    def recording_eval(*args, **kwargs):
        recorded["ref"] = jax_eval(*args, **kwargs)
        return recorded["ref"]

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_parity, "build_fixture",
                  lambda *a, **k: (classes, tmodel, ckpt))
    patch.setattr(jax_parity.build_fixture, "last_tries", tried, raising=False)
    patch.setattr(jax_parity, "torch_production_eval", recording_eval)
    try:
        jout = jax_parity._run_parity(root, 2, 8, 0, 96, screen_margin=1e-4,
                                      fixture="aligned")
    finally:
        patch.undo()
    return dict(root=root, reference=reference, jax_ref=recorded["ref"],
                jout=jout)


def test_reference_side_equals_jax_reference_run(small):
    preds, total_i, total_u, cands = small["jax_ref"]
    reference = small["reference"]
    assert reference["cands"] == cands
    assert len(reference["preds"]) == len(preds) == 2
    for p, q in zip(reference["preds"], preds):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(reference["total_i"], total_i)
    np.testing.assert_array_equal(reference["total_u"], total_u)


def test_run_parity_matches_jax_on_one_reference(small, tmp_path):
    # the reference through its .npz, as the card script passes it
    path = str(tmp_path / "reference.npz")
    seg_parity.save_reference(path, small["reference"])
    reference = seg_parity.load_reference(path)
    for p, q in zip(reference["preds"], small["reference"]["preds"]):
        np.testing.assert_array_equal(p, q)
    out = seg_parity.run_parity(2, 8, 0, 96, root=small["root"],
                                screen_margin=1e-4, fixture="aligned",
                                device="cpu", reference=reference)
    jout = small["jout"]
    assert list(out) == list(jout)
    assert [im["our_candidates"] for im in out["per_image"]] == \
        [im["our_candidates"] for im in jout["per_image"]]
    assert out["candidate_set_flips"] == jout["candidate_set_flips"]
    assert out["totals_ref"] == jout["totals_ref"]
    assert abs(out["pixel_disagreement"] - jout["pixel_disagreement"]) \
        <= PIXEL_TOL, (out["pixel_disagreement"], jout["pixel_disagreement"])
    assert abs(out["miou_delta"] - jout["miou_delta"]) <= MIOU_TOL, \
        (out["miou_delta"], jout["miou_delta"])
    for key in ("n_images", "n_classes", "seed", "size", "fixture",
                "screen_margin", "scenes_tried", "tome_r", "tome_schedule",
                "quant", "quant_towers", "miou_ref"):
        assert out[key] == jout[key], key


def canned_runs(n, empty_noflip=False):
    """Per-seed result dicts with seeded totals (the aggregate's input)."""
    rng = np.random.default_rng(n)
    runs = []
    for seed in range(n):
        def totals():
            u = rng.integers(0, 5000, 8).astype(float)
            u[rng.random(8) < 0.3] = 0.0
            return [list(np.floor(u * rng.random(8))), list(u)]
        nf = ([[0.0] * 8, [0.0] * 8] if empty_noflip else totals())
        runs.append(dict(
            pixel_disagreement=float(rng.random() * 0.03),
            miou_delta=float(rng.normal(0, 0.01)),
            max_class_iou_delta=float(rng.random() * 0.1),
            candidate_set_flips=int(rng.integers(0, 3)),
            scenes_tried=int(rng.integers(11, 40)), totals_ours=totals(),
            totals_ref=totals(), noflip_totals_ours=nf,
            noflip_totals_ref=[list(nf[0]), list(nf[1])],
            noflip_pixel_disagreement=float(rng.random() * 0.03)))
    return runs


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("empty_noflip", [False, True])
def test_aggregate_matches_jax(monkeypatch, capsys, empty_noflip):
    argv = ["--seeds", "0,1,2", "--images", "11", "--fixture", "aligned",
            "--screen_margin", "0.0015"]
    runs = iter(canned_runs(3, empty_noflip))
    monkeypatch.setattr(seg_parity, "run_parity",
                        lambda *a, **k: dict(next(runs)))
    seg_parity.main(argv + ["--device", "cpu"])
    got = last_json(capsys.readouterr().out)
    runs = iter(canned_runs(3, empty_noflip))
    monkeypatch.setattr(jax_parity, "run_parity",
                        lambda *a, **k: dict(next(runs)))
    monkeypatch.setattr(sys, "argv", ["seg_parity.py"] + argv)
    if empty_noflip:
        # JAX's aggregate raises where no class has support on both sides
        with np.errstate(all="ignore"), pytest.raises(ValueError):
            jax_parity.main()
        assert got["noflip_pooled_max_class_iou_delta"] == 0.0
        return
    jax_parity.main()
    want = last_json(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got == want


def test_main_prints_jax_keys_without_jax_or_opencv(small):
    """``main()`` in a fresh process on the CPU at 96 px: one JSON line with
    JAX's keys, and neither ``jax`` nor ``cv2`` imported."""
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(2)\n"
        "from simseg_tpu_torch.tools import seg_parity\n"
        "seg_parity.main(['--device', 'cpu', '--size', '96', '--images', '1', "
        "'--classes', '4'])\n"
        "print(json.dumps(sorted(m for m in ('jax', 'cv2', 'simseg_tpu', "
        "'tests') if m in sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    out = json.loads(lines[-2])
    assert list(out) == list(small["jout"])
    assert out["n_images"] == 1 and len(out["per_image"]) == 1


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seg_parity.main(["--images", "1"])
