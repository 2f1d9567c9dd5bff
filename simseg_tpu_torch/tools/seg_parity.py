"""Production-settings zero-shot segmentation parity harness (port of
``tools/seg_parity.py``).

Measures, at the real eval configuration (ViT-S/16 towers at 288 px, bf16
towers and CRF, the stride-8 bilateral CRF, the 7x7 closing, the nearest GT
resize), the end-to-end disagreement between:

- the port's pipeline on ``device`` (``tasks/seg_eval.make_seg_forward``,
  the code path ``tools/seg_evaluation.py`` runs, with the hand-written CRF
  kernels on the card), and
- the independent reference side of ``tools/parity_reference.py``, which
  always runs on the host: float32 torch towers, numpy decode heuristics
  and an *exact* mean-field dense CRF (no lattice or stride approximation)
  on palette scenes, where the exact CRF costs O(K N log N).

The reference side's result does not depend on the lane, so it is computed
once per fixture (``reference_side``) and can be passed to ``run_parity``,
which then compares any number of lanes against that one run.

Reported metrics (JSON on stdout), the JAX harness's keys:
- pixel_disagreement: the share of valid (non-255) GT pixels where the two
  pipelines' class maps differ;
- candidate_set_flips: images whose shortlisted candidate classes differ
  (the selection is threshold-gated, so a flip moves whole masks; it is
  counted apart, and the ``noflip_*`` metrics pool the other images);
- per-class IoU of both sides, the largest |delta| and the mIoU delta.

Usage:
    python -m simseg_tpu_torch.tools.seg_parity [--images 8] [--classes 8]
        [--seed 0] [--fixture aligned --screen_margin 0.0015]
        [--seeds 0,1,2] [--crf_dtype bfloat16|float32|auto] [--device cpu]

``--device`` defaults to CUDA and refuses to run without it; ``--crf_dtype``
defaults to bfloat16, the lane JAX's harness pins (the port's ``auto`` is
float32 on the card, where JAX's is bf16 on the TPU).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile
import warnings

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.tools.parity_reference import (TorchTinyCLIP,
                                                     candidate_decision,
                                                     class_palette,
                                                     normalized_nchw,
                                                     render_scene,
                                                     torch_pooled_scores,
                                                     torch_production_eval,
                                                     torch_text_bank)

PARITY_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "dog", "horse", "person", "sheep", "train",
]
TOP_CLS_NUM = 10                           # the VOC setting (reference :247)
CANVAS = 512                               # VOC's padded GT canvas


def make_parity_tokenizer(classes):
    """A WordPiece tokenizer covering the prompt bank and the class names
    (shared by both sides)."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    words = set()
    for t in IMAGENET_TEMPLATES:
        words.update(re.findall(r"[a-z]+", t.format("x").lower()))
    for c in classes:
        words.update(re.findall(r"[a-z]+", c.lower()))
    tok = WordPieceTokenizer(make_test_vocab(sorted(words)))
    if max(tok.vocab.values()) >= 256:
        raise ValueError("the parity vocab outgrew the BERT tower's 256 rows")
    return tok


def _make_parity_model(size: int, model_seed: int):
    """The fixture's reference-layout model: the ViT-S/16 image tower (the
    published simseg.vit-s architecture) and a mid-size BERT text tower
    (the bank builder)."""
    torch.manual_seed(model_seed)
    tmodel = TorchTinyCLIP(
        proj_dim=512,
        vit_kwargs=dict(img_size=size, patch=16, dim=384, depth=12, heads=6),
        bert_kwargs=dict(vocab=256, dim=384, depth=6, heads=6, inter=1536,
                         max_pos=64),
    )
    with torch.no_grad():
        for p in tmodel.parameters():
            if p.ndim > 0:
                p.add_(torch.randn_like(p) * 0.02)
    return tmodel


def _separate_text_classes(tmodel, tok, classes, alpha: float = 10.0):
    """Scale the class names' word-embedding rows so the class word moves
    each prompt's embedding: a random text tower maps every class's
    80-prompt mean to one direction (0.993 mean pairwise cosine), so every
    decode decision would differ by about 1e-4 of cosine."""
    ids = set()
    for c in classes:
        enc = tok([c], padding="max_length", truncation=True, max_length=25)
        row, msk = enc["input_ids"][0], enc["attention_mask"][0]
        toks = [t for t, m in zip(row, msk) if m]
        ids.update(toks[1:-1])  # [CLS] and [SEP] stripped
    table = tmodel.text_encoder.model.model.embeddings.word_embeddings.weight
    with torch.no_grad():
        table[sorted(ids)] *= alpha


def _align_image_projection(tmodel, bank, size: int, n_classes: int,
                            model_seed: int, patch: int = 16,
                            n_align_scenes: int = 6):
    """Solve the image projection so that patch projections align with
    their class's text embedding (ridge least squares over alignment
    scenes): random towers give featureless attention maps and 1e-4 score
    margins, where a trained model has informative attention. The solved
    weight rides the checkpoint like any other."""
    rng = np.random.default_rng(982_451 + model_seed)
    feats, targets = [], []
    with torch.no_grad():
        for _ in range(n_align_scenes):
            img, label = render_scene(rng, size, (size, size), n_classes)
            tokens = tmodel.image_encoder.model.model(
                normalized_nchw(img))[0, 1:].numpy()
            patch_cls = label[patch // 2::patch, patch // 2::patch].reshape(-1)
            feats.append(tokens)
            targets.append(bank[patch_cls])
    E = np.concatenate(feats, axis=0).astype(np.float64)
    T = np.concatenate(targets, axis=0).astype(np.float64)
    G = E.T @ E
    lam = 1e-3 * np.trace(G) / G.shape[0]
    W = np.linalg.solve(G + lam * np.eye(G.shape[0]), E.T @ T)  # (384, 512)
    with torch.no_grad():
        tmodel.image_projection.linear.weight.copy_(
            torch.tensor(W.T, dtype=torch.float32))


def _voc(root) -> str:
    return os.path.join(root, "VOCdevkit", "VOC2012")


def build_fixture(root, n_images: int, n_classes: int, seed: int,
                  size: int = 288, screen_margin: float = 0.0,
                  model_seed=None, max_length: int = 25,
                  top_cls_num: int = TOP_CLS_NUM, fixture: str = "random"):
    """A VOC2012-layout fixture of palette scenes and the reference-layout
    ViT-S/16 checkpoint under ``root``. Returns (classes, tmodel, ckpt path,
    scenes drawn).

    ``screen_margin > 0``: the model is pinned to ``model_seed`` (default 0)
    while scenes stream from ``seed``, and a scene is accepted only where
    the reference side's candidate decision is non-empty and holds at
    least ``screen_margin`` of score-threshold margin at every examined
    slot (unscreened scenes measure coin flips). ``fixture='aligned'`` also
    separates the class texts and solves the image projection against them
    (``_align_image_projection``).
    """
    from PIL import Image

    if fixture not in ("random", "aligned"):
        raise ValueError(f"unknown fixture mode {fixture!r} "
                         "(random|aligned)")
    classes = PARITY_CLASSES[:n_classes]
    aligned = fixture == "aligned"
    screening = screen_margin > 0.0
    if model_seed is None:
        model_seed = 0 if (screening or aligned) else seed
    tmodel = _make_parity_model(size, model_seed)
    bank = None
    if screening or aligned:
        tok = make_parity_tokenizer(classes)
        if aligned:
            _separate_text_classes(tmodel, tok, classes)
        bank = torch_text_bank(tmodel, tok, classes, max_length)
    if aligned:
        _align_image_projection(tmodel, bank, size, n_classes, model_seed)

    rng = np.random.default_rng(seed)
    voc = _voc(root)
    os.makedirs(os.path.join(voc, "JPEGImages"))
    os.makedirs(os.path.join(voc, "SegmentationClass"))
    os.makedirs(os.path.join(voc, "ImageSets", "Segmentation"))
    names = []
    accepted, tried = 0, 0
    max_tries = max(20 * n_images, 40)
    while accepted < n_images:
        gt_h = int(rng.integers(320, 512))
        gt_w = int(rng.integers(320, 512))
        img, label = render_scene(rng, size, (gt_h, gt_w), n_classes)
        tried += 1
        if screening:
            if tried > max_tries:
                raise RuntimeError(
                    f"screened fixture: {accepted}/{n_images} scenes after "
                    f"{tried} tries at margin {screen_margin} — lower the "
                    "margin or inspect the generator")
            scores = torch_pooled_scores(tmodel, bank, img)
            chosen, margin = candidate_decision(scores, n_classes,
                                                top_cls_num)
            if not chosen or margin < screen_margin:
                continue
        n = f"2007_{accepted:06d}"
        names.append(n)
        accepted += 1
        # PNG content under the .jpg name: the readers go by the header,
        # and JPEG's lossy DCT would break the palette the exact CRF needs
        Image.fromarray(img).save(
            os.path.join(voc, "JPEGImages", f"{n}.jpg"), format="PNG")
        Image.fromarray(label).save(
            os.path.join(voc, "SegmentationClass", f"{n}.png"))
    with open(os.path.join(voc, "ImageSets", "Segmentation", "val.txt"),
              "w") as f:
        f.write("\n".join(names))

    ckpt = os.path.join(root, "vit_s_parity.pth")
    torch.save({"state_dict": tmodel.state_dict()}, ckpt)
    return classes, tmodel, ckpt, tried


def fixture_batches(root):
    """The fixture's scenes as the reference side reads them, with PIL from
    the files (not through the port's loader): one dict an image, in
    ``val.txt`` order."""
    from PIL import Image

    voc = _voc(root)
    with open(os.path.join(voc, "ImageSets", "Segmentation", "val.txt")) as f:
        names = f.read().split()
    batches = []
    for n in names:
        img = np.asarray(Image.open(os.path.join(voc, "JPEGImages",
                                                 f"{n}.jpg")).convert("RGB"))
        label = np.asarray(Image.open(os.path.join(voc, "SegmentationClass",
                                                   f"{n}.png")))
        batches.append(dict(image=img[None], mask_label=label[None],
                            mask_h=[label.shape[0]], mask_w=[label.shape[1]]))
    return batches


def reference_side(root, classes, tmodel, tried: int,
                   max_length: int = 25) -> dict:
    """The reference eval on the fixture under ``root``, on the host:
    {"preds": per-image predictions at the GT size, "total_i", "total_u":
    per-class totals, "cands": candidate sets, "scenes_tried"}."""
    tok = make_parity_tokenizer(classes)
    preds, total_i, total_u, cands = torch_production_eval(
        tmodel, tok, fixture_batches(root), classes, len(classes),
        TOP_CLS_NUM, max_length=max_length)
    return dict(preds=preds, total_i=total_i, total_u=total_u, cands=cands,
                scenes_tried=int(tried))


def save_reference(path, ref: dict) -> None:
    """``reference_side``'s result as an ``.npz`` (no pickles)."""
    cands = np.full((len(ref["cands"]), 5), -1, np.int64)
    for i, c in enumerate(ref["cands"]):
        cands[i, :len(c)] = c
    np.savez(path, total_i=ref["total_i"], total_u=ref["total_u"],
             cands=cands, scenes_tried=ref["scenes_tried"],
             **{f"pred_{i}": p.astype(np.uint8)
                for i, p in enumerate(ref["preds"])})


def load_reference(path) -> dict:
    """The inverse of ``save_reference``."""
    with np.load(path) as z:
        n = len(z["cands"])
        return dict(preds=[z[f"pred_{i}"].astype(np.int64) for i in range(n)],
                    total_i=z["total_i"], total_u=z["total_u"],
                    cands=[[int(c) for c in row if c >= 0]
                           for row in z["cands"]],
                    scenes_tried=int(z["scenes_tried"]))


def make_parity_cfg(root, n_images: int, size: int = 288,
                    batch_size_val: int = 2, tome_r: int = 0,
                    quant: str = "none", stride: int = 8,
                    quant_towers: str = "both", tome_schedule=None,
                    crf_backend: str = "auto", crf_dtype: str = "bfloat16"):
    """The port's config tree of the harness (JAX ``make_parity_cfg``):
    ``--quant_towers image`` quantises the image tower only, the lane
    ``bench.py`` times (the class bank is built once a dataset)."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

    arch = {}
    if tome_r:
        arch["tome_r"] = int(tome_r)
    if tome_schedule:
        arch["tome_schedule"] = tuple(int(r) for r in tome_schedule)
    quantized = quant not in (None, "", "none")
    if quantized:
        arch["quant"] = str(quant)
    text_arch = {"vocab_size": 256, "hidden_dim": 384, "depth": 6,
                 "num_heads": 6, "intermediate_dim": 1536,
                 "max_position": 64, "type_vocab_size": 2}
    if quantized and quant_towers == "both":
        text_arch["quant"] = str(quant)
    return update_cfg(task_cfg_init_fn, None, argv=([
        f"model.image_encoder.arch={arch!r}",
    ] if arch else []) + [
        f"data.data_path={root}/",
        f"data.batch_size_val={batch_size_val}",
        # JAX's harness reads with one worker; the port's PNG reader takes
        # about 85 ms a scene on the host, so four decode threads (the
        # batches are the same either way)
        "data.num_workers=4",
        "model.max_length=25",
        "model.image_encoder.tag=vit_small_patch16_224",
        "model.text_encoder.tag=bert_parity",
        f"model.text_encoder.arch={text_arch!r}",
        "model.projection.name=simple",
        "model.projection.dim=512",
        "model.pool.name=loda",
        "model.pool.loda.image_k=5",
        "model.pool.loda.text_k=1",
        # production numerics: bf16 towers (configs/clip/simseg.vit-s.yaml
        # dist.bf16) and the CRF lane of --crf_dtype
        "dist.bf16=True",
        f"seg_eval.crf_dtype={crf_dtype}",
        f"seg_eval.bilateral_stride={int(stride)}",
        f"seg_eval.crf_backend={crf_backend}",
        f"transforms.input_size={size}",
        f"transforms.resize.size={size}",
        "transforms.valid_transforms=[resize]",
    ], target=new_base_cfg())


def run_parity(n_images: int = 8, n_classes: int = 8, seed: int = 0,
               size: int = 288, root=None, tome_r: int = 0,
               quant: str = "none", stride: int = 8,
               quant_towers: str = "both", tome_schedule=None,
               crf_backend: str = "auto", screen_margin: float = 0.0,
               fixture: str = "random", crf_dtype: str = "bfloat16",
               device=None, reference=None) -> dict:
    """Both pipelines on one fixture; the metric dict (JAX's keys). Owns
    (and removes) a temporary fixture directory unless ``root`` is given.

    reference: ``reference_side``'s result for the fixture already under
    ``root``; where given, the fixture is read as it is and the reference
    is not run again. ``device``: the port side's (default CUDA); the
    reference side runs on the host."""
    device = resolve_device(device)
    owns_root = root is None
    if owns_root:
        root = tempfile.mkdtemp(prefix="seg_parity_")
    try:
        return _run_parity(root, n_images, n_classes, seed, size, tome_r,
                           quant, stride, quant_towers, tome_schedule,
                           crf_backend, screen_margin, fixture, crf_dtype,
                           device, reference)
    finally:
        if owns_root:
            shutil.rmtree(root, ignore_errors=True)


def _confusion(pred, label, valid, n_classes):
    ci = np.zeros(n_classes, np.float64)
    cu = np.zeros(n_classes, np.float64)
    for c in range(n_classes):
        pi = (pred == c) & valid
        li = (label == c) & valid
        inter = np.sum(pi & li)
        ci[c] = inter
        cu[c] = pi.sum() + li.sum() - inter
    return ci, cu


def _run_parity(root, n_images, n_classes, seed, size, tome_r=0,
                quant="none", stride=8, quant_towers="both",
                tome_schedule=None, crf_backend="auto", screen_margin=0.0,
                fixture="random", crf_dtype="bfloat16", device=None,
                reference=None) -> dict:
    from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
    from simseg_tpu_torch.data.datasets import build_seg_valid_loader
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.tasks.seg_eval import (make_seg_features,
                                                 make_seg_forward,
                                                 prepare_quant_params,
                                                 zero_shot_classifier)
    from simseg_tpu_torch.utils.metrics import miou_from_totals

    device = resolve_device(device)
    classes = PARITY_CLASSES[:n_classes]
    if reference is None:
        classes, tmodel, _, tried = build_fixture(
            root, n_images, n_classes, seed, size,
            screen_margin=screen_margin, fixture=fixture)
        reference = reference_side(root, classes, tmodel, tried)
    ckpt = os.path.join(root, "vit_s_parity.pth")
    cfg = make_parity_cfg(root, n_images, size, tome_r=tome_r, quant=quant,
                          stride=stride, quant_towers=quant_towers,
                          tome_schedule=tome_schedule,
                          crf_backend=crf_backend, crf_dtype=crf_dtype)
    tok = make_parity_tokenizer(classes)
    mean = tuple(cfg.transforms.normalize.mean)
    std = tuple(cfg.transforms.normalize.std)

    # ---- the port's pipeline ----
    model = build_clip_model(cfg)
    report = load_clip_checkpoint(ckpt, model)
    if report["missing"] or report["mismatched"]:
        raise RuntimeError(f"the parity checkpoint does not fit: {report}")
    model = model.to(device).eval()
    # decoded once: int8_static calibrates on the same batches it evaluates
    batches = list(build_seg_valid_loader(cfg, "pascal_voc", device=device))
    if quant not in (None, "", "none"):
        # int8_static calibrates over the whole fixture (a running absmax
        # over every batch): one batch clips the other scenes' activation
        # outliers, which moves the pooled scores of the candidate threshold
        calib = None
        if quant == "int8_static":
            calib = torch.cat([torch.as_tensor(b["image"]) for b in batches])
        prepare_quant_params(model, input_size=size, mean=mean, std=std,
                             calib_images_u8=calib, tokenizer=tok,
                             classnames=classes, max_length=cfg.model.max_length,
                             device=device)
    text_bank = zero_shot_classifier(model, classes, tok,
                                     max_length=cfg.model.max_length,
                                     device=device)
    forward = make_seg_forward(
        model, n_classes, TOP_CLS_NUM, CANVAS, input_size=size, mean=mean,
        std=std, bilateral_stride=stride, patch_size=16,
        crf_backend=crf_backend, compute_dtype=crf_dtype, return_pred=True,
        device=device)
    # the decode's candidate selection replayed on the host from the same
    # pooled embeddings, to count candidate-set flips apart from pixels
    features = make_seg_features(model, input_size=size, mean=mean, std=std,
                                 patch_size=16, device=device)
    bank_host = text_bank.cpu().numpy()

    palette = {tuple(c) for cls in range(n_classes)
               for c in class_palette(cls)}
    labels_all, ours_preds, ours_cands = [], [], []
    total_i = np.zeros(n_classes, np.float64)
    total_u = np.zeros(n_classes, np.float64)
    for batch in batches:
        images = torch.as_tensor(batch["image"])
        seen = {tuple(c) for c in images.cpu().numpy().reshape(-1, 3)}
        if not seen <= palette:
            raise AssertionError(
                f"loader output left the palette ({len(seen - palette)} new "
                "colours): the identity resize must be lossless")
        labels = np.asarray(batch["mask_label"])
        b = images.shape[0]
        gt_h = np.asarray(batch.get("mask_h", [labels.shape[1]] * b), np.int64)
        gt_w = np.asarray(batch.get("mask_w", [labels.shape[2]] * b), np.int64)
        padded = np.full((b, CANVAS, CANVAS), 255, np.int64)
        padded[:, : labels.shape[1], : labels.shape[2]] = labels
        inter, union, pred = forward(images, text_bank,
                                     torch.from_numpy(padded),
                                     torch.from_numpy(gt_h),
                                     torch.from_numpy(gt_w))
        total_i += inter.cpu().numpy().astype(np.float64)
        total_u += union.cpu().numpy().astype(np.float64)
        pred = pred.cpu().numpy()
        pooled = features(images)[1].cpu().numpy()
        for bi in range(b):
            labels_all.append(labels[bi, : gt_h[bi], : gt_w[bi]])
            ours_preds.append(pred[bi, : gt_h[bi], : gt_w[bi]])
            ours_cands.append(candidate_decision(
                pooled[bi] @ bank_host.T, n_classes, TOP_CLS_NUM)[0])
    if len(ours_preds) != len(reference["preds"]):
        raise AssertionError(f"{len(ours_preds)} scenes through the loader, "
                             f"{len(reference['preds'])} in the reference")

    # ---- the comparison ----
    ref_i, ref_u = reference["total_i"], reference["total_u"]
    flips = disagree = valid_total = 0
    # "noflip": the scenes where both pipelines chose one candidate set;
    # a flip moves whole masks and is counted and gated apart
    nf_disagree = nf_valid = 0
    nf_i_ours = np.zeros(n_classes, np.float64)
    nf_u_ours = np.zeros(n_classes, np.float64)
    nf_i_ref = np.zeros(n_classes, np.float64)
    nf_u_ref = np.zeros(n_classes, np.float64)
    per_image = []
    for idx, label in enumerate(labels_all):
        valid = label != 255
        ours, ref = ours_preds[idx], reference["preds"][idx]
        d = int(((ours != ref) & valid).sum())
        v = int(valid.sum())
        disagree += d
        valid_total += v
        if set(ours_cands[idx]) != set(reference["cands"][idx]):
            flips += 1
        else:
            nf_disagree += d
            nf_valid += v
            ci, cu = _confusion(ours, label, valid, n_classes)
            nf_i_ours += ci
            nf_u_ours += cu
            ci, cu = _confusion(ref, label, valid, n_classes)
            nf_i_ref += ci
            nf_u_ref += cu
        per_image.append(dict(pixels=v, disagree=d,
                              ref_candidates=reference["cands"][idx],
                              our_candidates=ours_cands[idx]))

    iou_ours, miou_ours = miou_from_totals(total_i, total_u)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou_ref = ref_i / ref_u
    miou_ref = float(np.nanmean(iou_ref))
    both = ~(np.isnan(np.asarray(iou_ours)) | np.isnan(iou_ref))
    iou_delta = float(np.max(np.abs(np.asarray(iou_ours)[both]
                                    - iou_ref[both]))) if both.any() else 0.0

    return dict(
        n_images=n_images,
        n_classes=n_classes,
        seed=seed,
        size=size,
        fixture=fixture,
        screen_margin=screen_margin,
        scenes_tried=reference["scenes_tried"],
        tome_r=tome_r,
        tome_schedule=list(tome_schedule) if tome_schedule else None,
        quant=quant,
        quant_towers=quant_towers,
        pixel_disagreement=disagree / max(valid_total, 1),
        candidate_set_flips=flips,
        miou_ours=float(miou_ours),
        miou_ref=miou_ref,
        miou_delta=float(miou_ours - miou_ref),
        max_class_iou_delta=iou_delta,
        iou_ours=[None if np.isnan(v) else round(float(v), 4)
                  for v in np.asarray(iou_ours)],
        iou_ref=[None if np.isnan(v) else round(float(v), 4)
                 for v in iou_ref],
        # raw confusion totals, so a multi-seed sweep pools per-class IoU
        # over all its scenes
        totals_ours=[list(map(float, total_i)), list(map(float, total_u))],
        totals_ref=[list(map(float, ref_i)), list(map(float, ref_u))],
        noflip_pixel_disagreement=nf_disagree / max(nf_valid, 1),
        noflip_totals_ours=[list(nf_i_ours), list(nf_u_ours)],
        noflip_totals_ref=[list(nf_i_ref), list(nf_u_ref)],
        per_image=per_image,
    )


def pooled_deltas(runs, key_ours, key_ref):
    """(mIoU delta, largest class |IoU delta|) of per-class IoU pooled over
    every run's totals. The class delta is 0.0 where no class has support
    on both sides (JAX's aggregate raises there, ``tools/seg_parity.py:1038``;
    its single-run path guards it, ``:920-921``)."""
    oi = np.sum([r[key_ours][0] for r in runs], axis=0)
    ou = np.sum([r[key_ours][1] for r in runs], axis=0)
    ri = np.sum([r[key_ref][0] for r in runs], axis=0)
    ru = np.sum([r[key_ref][1] for r in runs], axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou_o, iou_r = oi / ou, ri / ru
    both = ~(np.isnan(iou_o) | np.isnan(iou_r))
    cls = float(np.max(np.abs(iou_o[both] - iou_r[both]))) if both.any() \
        else 0.0
    with warnings.catch_warnings():
        # a side with no class support has a NaN mIoU, as in JAX
        warnings.simplefilter("ignore", RuntimeWarning)
        miou = float(np.nanmean(iou_o) - np.nanmean(iou_r))
    return miou, cls


def aggregate(runs, args) -> dict:
    """The multi-seed summary with its gate margins (JAX ``main``'s
    ``--seeds`` JSON): the aligned fixture's catastrophe bounds at the
    worst point, pixel < 4% a seed, noflip pooled |mIoU delta| < 2.5 pt,
    noflip pooled class delta < 20 pt, flips <= 15% of the scenes."""
    pix = [r["pixel_disagreement"] for r in runs]
    miou_d = [abs(r["miou_delta"]) for r in runs]
    cls_d = [r["max_class_iou_delta"] for r in runs]
    flips = sum(r["candidate_set_flips"] for r in runs)
    n_scenes = args.images * len(runs)
    pooled_miou, pooled_cls = pooled_deltas(runs, "totals_ours", "totals_ref")
    nf_miou, nf_cls = pooled_deltas(runs, "noflip_totals_ours",
                                    "noflip_totals_ref")
    nf_pix = [r["noflip_pixel_disagreement"] for r in runs]
    return dict(
        aggregate=True, n_scenes=n_scenes, seeds=args.seeds,
        fixture=args.fixture, screen_margin=args.screen_margin,
        scenes_tried=sum(r.get("scenes_tried", args.images) for r in runs),
        pixel_mean=float(np.mean(pix)), pixel_worst=float(np.max(pix)),
        miou_delta_mean=float(np.mean(miou_d)),
        miou_delta_worst=float(np.max(miou_d)),
        max_class_iou_delta_worst=float(np.max(cls_d)),
        pooled_miou_delta=pooled_miou,
        pooled_max_class_iou_delta=pooled_cls,
        candidate_set_flips=flips,
        noflip_pixel_worst=float(np.max(nf_pix)),
        noflip_pooled_miou_delta=nf_miou,
        noflip_pooled_max_class_iou_delta=nf_cls,
        margin_pixel_pct=float(4.0 - 100.0 * np.max(nf_pix)),
        margin_miou_pt=float(2.5 - 100.0 * abs(nf_miou)),
        margin_class_pt=float(20.0 - 100.0 * nf_cls),
        margin_flips=float(0.15 - flips / max(n_scenes, 1)),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=288)
    ap.add_argument("--tome_r", type=int, default=0,
                    help="token merging r (quality-cost measurement)")
    ap.add_argument("--tome_schedule", type=str, default="",
                    help="comma-separated per-block merge counts "
                         "(e.g. 48,0,0,48,0,0,48,0,0,48,0,0); overrides "
                         "--tome_r")
    ap.add_argument("--quant", type=str, default="none",
                    help="int8 inference lane (quality-cost measurement)")
    ap.add_argument("--stride", type=int, default=8,
                    help="CRF bilateral stride, priced against the exact "
                         "stride-free reference")
    ap.add_argument("--crf_backend", type=str, default="auto",
                    help="the CRF lane (auto|fused|fused_tail|xla|pallas)")
    ap.add_argument("--quant_towers", type=str, default="both",
                    choices=["both", "image"],
                    help="which towers --quant applies to; 'image' is "
                         "bench.py's quant lanes")
    ap.add_argument("--seeds", type=str, default="",
                    help="comma list of fixture seeds: runs every seed and "
                         "prints one aggregated JSON with per-gate margins")
    ap.add_argument("--fixture", type=str, default="random",
                    choices=["random", "aligned"],
                    help="'aligned' solves the image projection against the "
                         "class text bank (informative attention, real "
                         "margins)")
    ap.add_argument("--screen_margin", type=float, default=0.0,
                    help="margin-screened scenes: the model pinned to seed "
                         "0, scenes from --seed(s), accepted only with a "
                         "non-empty reference candidate set at >= this "
                         "score-threshold margin")
    ap.add_argument("--crf_dtype", type=str, default="bfloat16",
                    choices=["bfloat16", "float32", "auto"],
                    help="the CRF's compute dtype (auto: float32 on the card)")
    ap.add_argument("--device", type=str, default=None,
                    help="the port side's torch device (default: CUDA)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    sched = (tuple(int(x) for x in args.tome_schedule.split(","))
             if args.tome_schedule else None)
    lane = dict(tome_r=args.tome_r, quant=args.quant, stride=args.stride,
                quant_towers=args.quant_towers, tome_schedule=sched,
                crf_backend=args.crf_backend,
                screen_margin=args.screen_margin, fixture=args.fixture,
                crf_dtype=args.crf_dtype, device=device)
    if args.seeds:
        runs = []
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_parity(args.images, args.classes, seed, args.size, **lane)
            r.pop("per_image", None)
            runs.append(r)
            print(json.dumps(r), flush=True)
        print(json.dumps(aggregate(runs, args)))
        return
    print(json.dumps(run_parity(args.images, args.classes, args.seed,
                                args.size, **lane)))


if __name__ == "__main__":
    main()
