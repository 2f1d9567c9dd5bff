"""PyTorch port (simseg_tpu_torch): the segmentation eval end to end on the
aligned parity fixture (``tools/seg_parity.py:build_fixture(...,
fixture="aligned")``: palette scenes in the VOC2012 layout, a ViT-S/16 +
6-layer BERT ``.pth`` whose image projection is solved to align patches
with the class texts, screened to a candidate margin of 0.0015), against
the JAX package on the same files, in float32.

- ``make_seg_forward(return_pred=True)``: both packages load the ``.pth``
  through their own bridge and read the batches through their own loader
  (held bit-equal by ``test_torch_port_seg_data.py``, and again here). Bars:
  the same candidate set on every image, and >= 99.9% of the GT-sized
  pixels predicting the same class.
- The port's ``seg_evaluation`` CLI on the CPU against JAX's
  ``evaluate_benchmark`` on the same config: mIoU within 1e-3 (the pixel
  bar's share), the per-class IoU of each class both see within 1e-2.

The fixture has 4 scenes at 288 px, as JAX's own aligned test
(``tests/test_seg_parity_production.py:170-182``), which is marked slow;
here both towers run once per package on 2 batches of 2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simseg_tpu.tasks.seg_eval as jax_seg_eval
from simseg_tpu.checkpoint.torch_bridge import load_clip_checkpoint as jax_load
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.data.datasets import build_seg_valid_loader as jax_loader
from simseg_tpu.data.transforms import normalize_images as jax_normalize
from simseg_tpu.models.clip import build_clip_model as jax_build_model
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.datasets import build_seg_valid_loader
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
from simseg_tpu_torch.models.clip import build_clip_model
from simseg_tpu_torch.tasks import seg_eval
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.tools import seg_evaluation
from tools.seg_parity import (build_fixture, candidate_decision,
                              make_parity_tokenizer)

torch.set_num_threads(2)

N_SCENES = 4
N_CLASSES = 16
TOP_CLS = 10
CANVAS = 512
PIXEL_BAR = 0.999
MIOU_BAR = 1e-3
IOU_BAR = 1e-2

YAML = """\
data:
  data_path: {root}/
  batch_size_val: 2
  num_workers: 2
  valid_name: [pascal_voc]
transforms:
  input_size: 288
  valid_transforms: [resize]
  resize:
    size: 288
model:
  max_length: 25
  image_encoder:
    tag: vit_small_patch16_224
  text_encoder:
    tag: bert_parity
    arch: {{vocab_size: 256, hidden_dim: 384, depth: 6, num_heads: 6,
            intermediate_dim: 1536, max_position: 64, type_vocab_size: 2}}
  projection:
    name: simple
    dim: 512
  pool:
    name: loda
    loda:
      image_k: 5
      text_k: 1
dist:
  bf16: False
seg_eval:
  bilateral_stride: 8
"""


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """The fixture directory, read-only after this: the scenes, the .pth,
    a vocab.txt of the parity tokenizer, the config and the label bank
    (``data/label_category/pascal_voc.txt``, which the CLI reads relative
    to the working directory, holding the fixture's classes)."""
    root = str(tmp_path_factory.mktemp("aligned"))
    classes, _, ckpt = build_fixture(root, N_SCENES, N_CLASSES, 1, 288,
                                     screen_margin=0.0015, fixture="aligned")
    tok = make_parity_tokenizer(classes)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")
    yaml_path = os.path.join(root, "parity.yaml")
    with open(yaml_path, "w") as f:
        f.write(YAML.format(root=root))
    os.makedirs(os.path.join(root, "data", "label_category"))
    with open(os.path.join(root, "data", "label_category", "pascal_voc.txt"),
              "w") as f:
        f.write("\n".join(classes) + "\n")
    jcfg = jax_update_cfg(jax_task_cfg_init_fn, yaml_path,
                          target=jax_new_base_cfg())
    cfg = update_cfg(task_cfg_init_fn, yaml_path, target=new_base_cfg())
    return dict(root=root, classes=classes, ckpt=ckpt, tok=tok, vocab=vocab,
                yaml=yaml_path, jcfg=jcfg, cfg=cfg)


@pytest.fixture(scope="module")
def jax_side(aligned):
    jcfg = aligned["jcfg"]
    model = jax_build_model(jcfg)
    dummy = {"image": jnp.zeros((1, 288, 288, 3)),
             "input_ids": jnp.zeros((1, 25), jnp.int32),
             "attention_mask": jnp.ones((1, 25), jnp.int32)}
    params = model.init(jax.random.key(0), dummy)
    params, report = jax_load(aligned["ckpt"], params)
    assert not report["missing"] and not report["mismatched"], report
    return model, params


@pytest.fixture(scope="module")
def port_model(aligned):
    model = build_clip_model(aligned["cfg"])
    report = load_clip_checkpoint(aligned["ckpt"], model)
    assert not report["missing"] and not report["mismatched"], report
    return model.eval()


def test_seg_forward_matches_jax_on_the_aligned_fixture(aligned, jax_side,
                                                        port_model):
    model, params = jax_side
    classes, jcfg = aligned["classes"], aligned["jcfg"]
    port_tok = WordPieceTokenizer.from_vocab_file(aligned["vocab"])
    jbank = jax_seg_eval.zero_shot_classifier(model, params, classes,
                                              aligned["tok"], max_length=25)
    bank = seg_eval.zero_shot_classifier(port_model, classes, port_tok,
                                         max_length=25, device="cpu")
    jforward = jax_seg_eval.make_seg_forward(
        model, jcfg, N_CLASSES, TOP_CLS, CANVAS, patch_size=16,
        return_pred=True)
    forward = seg_eval.make_seg_forward(
        port_model, N_CLASSES, TOP_CLS, CANVAS, input_size=288,
        bilateral_stride=8, return_pred=True, device="cpu")
    features = seg_eval.make_seg_features(port_model, input_size=288,
                                          device="cpu")

    @jax.jit
    def jpooled(params, images_u8):
        tokens = model.apply(params, jax_normalize(images_u8),
                             method=lambda m, im: m.forward_image_tokens(im))
        return model.apply(params, tokens[:, 1:],
                           method=lambda m, t: m.forward_image_project(t))

    jbatches = list(jax_loader(jcfg, "pascal_voc"))
    batches = list(build_seg_valid_loader(aligned["cfg"], "pascal_voc",
                                          device="cpu"))
    assert len(batches) == len(jbatches) == N_SCENES // 2
    same = total = flips = 0
    for jb, b in zip(jbatches, batches):
        np.testing.assert_array_equal(b["image"].numpy(), jb["image"])
        labels = jb["mask_label"]
        n = labels.shape[0]
        gt_h = np.asarray(jb.get("mask_h", [labels.shape[1]] * n), np.int32)
        gt_w = np.asarray(jb.get("mask_w", [labels.shape[2]] * n), np.int32)
        padded = np.full((n, CANVAS, CANVAS), 255, np.int32)
        padded[:, :labels.shape[1], :labels.shape[2]] = labels
        _, _, jpred = jforward(params, jnp.asarray(jb["image"]), jbank,
                               jnp.asarray(padded), jnp.asarray(gt_h),
                               jnp.asarray(gt_w))
        _, _, pred = forward(b["image"], bank, torch.from_numpy(padded).long(),
                             torch.from_numpy(gt_h), torch.from_numpy(gt_w))
        jscores = np.asarray(jpooled(params, jnp.asarray(jb["image"]))) @ \
            np.asarray(jbank).T
        scores = features(b["image"])[1].numpy() @ bank.numpy().T
        jpred, pred = np.asarray(jpred), pred.numpy()
        for i in range(n):
            jc = candidate_decision(jscores[i], N_CLASSES, TOP_CLS)[0]
            pc = candidate_decision(scores[i], N_CLASSES, TOP_CLS)[0]
            flips += set(jc) != set(pc)
            h, w = gt_h[i], gt_w[i]
            same += int((jpred[i, :h, :w] == pred[i, :h, :w]).sum())
            total += int(h * w)
    assert flips == 0
    assert same / total >= PIXEL_BAR, same / total


def test_cli_matches_jax_evaluate_benchmark(aligned, jax_side, monkeypatch):
    model, params = jax_side
    monkeypatch.chdir(aligned["root"])
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        jax_loader(aligned["jcfg"], "pascal_voc"), model, params,
        aligned["jcfg"], aligned["tok"], aligned["classes"], TOP_CLS,
        "pascal_voc")
    results = seg_evaluation.main([
        "--cfg", aligned["yaml"], "--ckpt_path", aligned["ckpt"],
        "--vocab_file", aligned["vocab"], "--device", "cpu"])
    iou, miou = results["pascal_voc"]
    assert iou.shape == jiou.shape == (N_CLASSES,)
    np.testing.assert_array_equal(np.isnan(iou), np.isnan(jiou))
    both = ~np.isnan(iou)
    assert np.all(np.abs(iou[both] - jiou[both]) <= IOU_BAR), (iou, jiou)
    assert abs(miou - jmiou) <= MIOU_BAR, (miou, jmiou)
    assert 0.0 < miou <= 1.0


def test_cli_needs_a_vocab_file(aligned):
    with pytest.raises(SystemExit, match="--vocab_file"):
        seg_evaluation.main(["--cfg", aligned["yaml"], "--device", "cpu"])


# -- the CLI's decode knobs on a tiny model -------------------------------------

TINY_YAML = """\
data:
  data_path: {root}/
  batch_size_val: 2
  num_workers: 1
  valid_name: [pascal_voc]
transforms:
  input_size: 64
  valid_transforms: [resize]
  resize:
    size: 64
model:
  max_length: 25
  image_encoder:
    tag: vit_test
  text_encoder:
    tag: bert_test
    arch: {{vocab_size: 256}}
  projection:
    name: simple
    dim: 16
  pool:
    name: loda
    loda:
      image_k: 3
      text_k: 1
dist:
  bf16: False
seg_eval:
  bilateral_stride: 4
"""
KNOBS = [(b, d) for b in ("auto", "xla", "pallas", "fused", "fused_tail")
         for d in ("auto", "float32", "bfloat16")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """3 scenes, a tiny CLIP .pth written from the port's model (the
    reference's names), its config, vocab and label bank."""
    import functools

    import simseg_tpu.ops.crf_fused as jax_crf_fused
    import simseg_tpu.ops.crf_pallas as jax_crf_pallas

    root = str(tmp_path_factory.mktemp("tiny"))
    classes = build_fixture(root, 3, 8, 0, 288)[0]
    tok = make_parity_tokenizer(classes)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")
    yaml_path = os.path.join(root, "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write(TINY_YAML.format(root=root))
    os.makedirs(os.path.join(root, "data", "label_category"))
    with open(os.path.join(root, "data", "label_category", "pascal_voc.txt"),
              "w") as f:
        f.write("\n".join(classes) + "\n")
    cfg = update_cfg(task_cfg_init_fn, yaml_path, target=new_base_cfg())
    torch.manual_seed(3)
    ckpt = os.path.join(root, "tiny.pth")
    torch.save({"state_dict": build_clip_model(cfg).state_dict()}, ckpt)
    # JAX's kernel lanes run in interpret mode on the CPU, as its own tests
    # run them
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_crf_pallas, "bilateral_matvec_batched", functools.partial(
        jax_crf_pallas.bilateral_matvec_batched, interpret=True))
    patch.setattr(jax_crf_fused, "mean_field_fused", functools.partial(
        jax_crf_fused.mean_field_fused, interpret=True))
    yield dict(root=root, classes=classes, tok=tok, vocab=vocab,
               yaml=yaml_path, ckpt=ckpt)
    patch.undo()


@pytest.mark.parametrize("backend,dtype", KNOBS)
def test_cli_takes_every_decode_knob(tiny, monkeypatch, backend, dtype):
    """``seg_eval.crf_backend`` x ``seg_eval.crf_dtype`` through the CLI on
    the CPU against JAX's ``evaluate_benchmark`` on the same config: mIoU
    within 1e-3 in float32, 1e-2 in bf16 (the decode bars' shares); bf16 on
    a kernel lane raises."""
    monkeypatch.chdir(tiny["root"])
    argv = ["--cfg", tiny["yaml"], "--ckpt_path", tiny["ckpt"],
            "--vocab_file", tiny["vocab"], "--device", "cpu",
            f"seg_eval.crf_backend={backend}", f"seg_eval.crf_dtype={dtype}"]
    if dtype == "bfloat16" and backend in ("pallas", "fused", "fused_tail"):
        with pytest.raises(NotImplementedError, match="item 4"):
            seg_evaluation.main(argv)
        return
    iou, miou = seg_evaluation.main(argv)["pascal_voc"]
    jcfg = jax_update_cfg(jax_task_cfg_init_fn, tiny["yaml"], argv=[
        f"seg_eval.crf_backend={backend}", f"seg_eval.crf_dtype={dtype}"],
        target=jax_new_base_cfg())
    model = jax_build_model(jcfg)
    dummy = {"image": jnp.zeros((1, 64, 64, 3)),
             "input_ids": jnp.zeros((1, 25), jnp.int32),
             "attention_mask": jnp.ones((1, 25), jnp.int32)}
    params, report = jax_load(tiny["ckpt"], model.init(jax.random.key(0), dummy))
    assert not report["missing"] and not report["mismatched"], report
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        jax_loader(jcfg, "pascal_voc"), model, params, jcfg, tiny["tok"],
        tiny["classes"], TOP_CLS, "pascal_voc")
    assert abs(miou - jmiou) <= (1e-2 if dtype == "bfloat16" else MIOU_BAR), \
        (miou, jmiou)
