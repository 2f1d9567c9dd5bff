"""PyTorch port (simseg_tpu_torch): CLIP with a CNN image tower
(``resnet_test``, 32 px; ``tests/test_models.py:tiny_clip``) against the
JAX package on the CPU — live-BN training steps in one process and over a
gloo world of two CPU processes (``tests/test_torch_port_distributed.py``'s
way), the refusal of BSGS with live BN, and ``evaluate_benchmark``.

JAX's live-BN step is ``make_train_step`` with ``bn_training`` (the
runner's ``freeze_cnn_bn: false``); its statistics are the global
batch's, so two ranks must sum theirs over the world to meet it.

JAX's seg eval cannot run a CNN tower: its ``_tower`` drops the first
token of every tower as a CLS token, and the decode then asserts on h·w - 1
tokens. The reference here is JAX's own pieces composed without that drop
(``forward_image_tokens``, ``forward_image_project``,
``project_image_tokens``, ``l2_normalize``, ``make_seg_decode_fn``,
``resize_nearest_to_padded``, ``intersect_and_union``,
``miou_from_totals``) at the tower's grid step, 8 for the two-stage
``resnet_test``.

Bars: loss within rtol 1e-5 at every step, parameters within JAX's mesh
bar (rtol 2e-4, atol 1e-6), running statistics within rtol 1e-5 (and 1e-5
of each buffer's largest entry); the ranks bit-equal to each other;
per-class IoU and mIoU equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.core.optim import build_optimizer as jax_build_optimizer
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.data.transforms import normalize_images as jax_normalize
from simseg_tpu.engine.train_step import TrainState
from simseg_tpu.engine.train_step import make_train_step as jax_make_train_step
from simseg_tpu.ops.morphology import resize_nearest_to_padded as jax_resize
from simseg_tpu.ops.pooling import l2_normalize as jax_l2
from simseg_tpu.ops.seg_decode import make_seg_decode_fn as jax_decode_fn
from simseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from simseg_tpu.parallel.mesh import shard_batch
from simseg_tpu.tasks.seg_eval import zero_shot_classifier as jax_zero_shot
from simseg_tpu.utils.metrics import intersect_and_union as jax_iu
from simseg_tpu.utils.metrics import miou_from_totals as jax_miou
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark
from tests.test_models import tiny_clip
from tests.test_torch_port_cnn import _perturbed
from tests.test_torch_port_distributed import run_world
from tests.test_torch_port_seg import CLASSES, WORDS, _Loader
from tests.test_torch_port_train import SEQ, TINY, _trees

torch.set_num_threads(2)

TAG = "resnet_test"
LR = 1e-2
SGD = ["optim.name=torch.optim.SGD", "optim.param={'momentum': 0.9}",
       "optim.lr.name=constant_schedule", f"optim.lr.init={LR}",
       "model.image_encoder.tag=resnet_test"]
STEPS, BATCH = 2, 8


def _pair(seed=0):
    flax_model = tiny_clip(image_tag=TAG)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)),
             "input_ids": jnp.zeros((1, SEQ), jnp.int32),
             "attention_mask": jnp.ones((1, SEQ), jnp.int32)}
    variables = _perturbed(jax.tree.map(
        np.asarray, flax_model.init(jax.random.key(seed), dummy)), seed)
    port = CLIPModel(image_tag=TAG, img_size=32, text_tag="bert_test",
                     projection_dim=16, image_k=3)
    port.load_state_dict(flax_params_to_state_dict(variables), strict=True)
    return flax_model, variables, port


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        mask = np.ones((BATCH, SEQ), np.int64)
        mask[1, 5:] = 0
        out.append({"image": rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32),
                    "input_ids": rng.integers(0, 128, (BATCH, SEQ)),
                    "attention_mask": mask})
    return out


def _jax_steps(flax_model, variables, world):
    _, ref_cfg = _trees(TINY + SGD + [f"data.batch_size={BATCH}"])
    mesh = jax_make_mesh(jax.devices()[:world])
    tx, set_lr = jax_build_optimizer(ref_cfg, variables,
                                     frozen_patterns=(r"^batch_stats/",))
    state = TrainState.create(variables, tx)
    step = jax_make_train_step(flax_model, tx, set_lr, mesh=mesh, donate=False,
                               bn_training=True)
    losses = []
    for batch in _batches():
        state, m = step(state, shard_batch(batch, mesh), None, LR)
        losses.append(float(m["loss"]))
    return losses, flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                          state.params))


def _assert_state_close(got, want):
    for key, value in got.items():
        a, b = value.numpy(), want[key].numpy()
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(), err_msg=key)
        elif key.endswith("num_batches_tracked"):
            assert a == b == 0
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6, err_msg=key)


def test_live_bn_steps_match_jax():
    flax_model, variables, port = _pair()
    cfg, _ = _trees(TINY + SGD + [f"data.batch_size={BATCH}"])
    runner = CLIPRunner(cfg, port, {"train": []}, device="cpu")
    losses = []
    for batch in _batches():
        losses.append(float(runner.batch_processor(
            {k: torch.from_numpy(v) for k, v in batch.items()})["loss"]))
        runner.step += 1
    want_losses, want = _jax_steps(flax_model, variables, 1)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    moved = flax_params_to_state_dict(variables)
    key = "image_encoder.model.model.bn1.running_var"
    assert not torch.equal(port.state_dict()[key], moved[key])
    _assert_state_close(port.state_dict(), want)


def test_frozen_bn_keeps_the_running_statistics():
    _, _, port = _pair()
    cfg, _ = _trees(TINY + SGD + [f"data.batch_size={BATCH}",
                                  "model.freeze_cnn_bn=true"])
    before = {k: v.clone() for k, v in port.state_dict().items()
              if "running" in k}
    runner = CLIPRunner(cfg, port, {"train": []}, device="cpu")
    runner.batch_processor({k: torch.from_numpy(v)
                            for k, v in _batches()[0].items()})
    for k, v in before.items():
        assert torch.equal(port.state_dict()[k], v), k


def test_bsgs_refuses_live_bn_as_jax_does():
    _, _, port = _pair()
    cfg, _ = _trees(TINY + SGD + ["data.batch_size=8", "runner.name=clip_bsgs",
                                  "data.batch_size_train=4"])
    with pytest.raises(NotImplementedError, match="does not thread live "
                                                  "BatchNorm"):
        CLIPRunner(cfg, port, {"train": []}, device="cpu")


WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from simseg_tpu_torch import config
from simseg_tpu_torch.core.runner import CLIPRunner
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.parallel import init_distributed, rank, world_size
from simseg_tpu_torch.tasks.clip import config as clip_config

init_distributed(device="cpu", timeout=60)
r, w = rank(), world_size()
out = os.environ["OUT"]
argv = os.environ["ARGV"].split("|")
cfg = config.update_cfg(clip_config.task_cfg_init_fn, None, argv,
                        preprocess_fn=clip_config.update_clip_config,
                        target=config.new_base_cfg())
model = CLIPModel(image_tag="resnet_test", img_size=32, text_tag="bert_test",
                  projection_dim=16, image_k=3)
model.load_state_dict(torch.load(os.environ["STATE"]))
runner = CLIPRunner(cfg, model, {"train": []}, device="cpu")
data = np.load(os.environ["BATCHES"])
losses = []
for s in range(int(os.environ["STEPS"])):
    n = data[f"{s}_image"].shape[0] // w
    local = {k: torch.from_numpy(data[f"{s}_{k}"][r * n:(r + 1) * n])
             for k in ("image", "input_ids", "attention_mask")}
    losses.append(float(runner.batch_processor(local)["loss"]))
    runner.step += 1
torch.save({"losses": losses, "state": runner.model.state_dict()},
           f"{out}/rank_{r}.pt")
'''


def test_live_bn_over_two_ranks_matches_jax(tmp_path):
    """Each rank holds half of every batch; the BN sums go over the world,
    so the statistics, the losses and the parameters are JAX's (its pjit
    forward sees the global batch)."""
    flax_model, variables, port = _pair()
    torch.save(port.state_dict(), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **{
        f"{s}_{k}": v for s, b in enumerate(_batches()) for k, v in b.items()})
    run_world(2, WORKER, {"OUT": str(tmp_path), "STATE": str(tmp_path / "state.pt"),
                          "BATCHES": str(tmp_path / "batches.npz"),
                          "STEPS": str(STEPS),
                          "ARGV": "|".join(TINY + SGD + [f"data.batch_size={BATCH}"])})
    ranks = [torch.load(tmp_path / f"rank_{r}.pt") for r in range(2)]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert ranks[0]["losses"] == ranks[1]["losses"]
    want_losses, want = _jax_steps(flax_model, variables, 2)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=1e-5)
    _assert_state_close(ranks[0]["state"], want)


# ---------------------------------------------------------- seg eval

def _jax_cnn_benchmark(flax_model, variables, tokenizer, size, stride):
    """JAX's per-class IoU and mIoU of ``_Loader`` through JAX's pieces,
    the CNN's every token kept."""
    bank = jax_zero_shot(flax_model, variables, CLASSES, tokenizer,
                         max_length=12)
    decode = jax_decode_fn(num_classes=len(CLASSES), image_size=size,
                           patch_size=stride, top_cls_num=4,
                           candidate_classes=5, bilateral_stride=4)
    total_i = np.zeros(len(CLASSES))
    total_u = np.zeros(len(CLASSES))
    for batch in _Loader():
        images = np.asarray(batch["image"])
        pad = _Loader.batch_size - images.shape[0]
        labels = np.asarray(batch["mask_label"])
        b = images.shape[0]
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                                  np.uint8)])
        x = jax_normalize(jnp.asarray(images))
        tokens = flax_model.apply(variables, x,
                                  method=lambda m, im: m.forward_image_tokens(im))
        pooled = flax_model.apply(variables, tokens,
                                  method=lambda m, t: m.forward_image_project(t))
        dense = flax_model.apply(variables, tokens,
                                 method=lambda m, t: m.project_image_tokens(t))
        pred, _ = decode(jax_l2(dense.astype(jnp.float32)),
                         pooled.astype(jnp.float32), jnp.asarray(bank),
                         jnp.asarray(images))
        for i in range(b):
            canvas = np.full((48, 48), 255, np.int32)
            canvas[:labels.shape[1], :labels.shape[2]] = labels[i]
            r = jax_resize(pred[i], 40, 48, 48, 48, fill=0)
            inter, union, _, _ = jax_iu(r, jnp.asarray(canvas), len(CLASSES), 255)
            total_i += np.asarray(inter, np.float64)
            total_u += np.asarray(union, np.float64)
    return jax_miou(total_i, total_u)


def test_cnn_evaluate_benchmark_matches_jax_pieces():
    flax_model, variables, port = _pair()
    stride = 8
    assert port.patch_size == stride
    jiou, jmiou = _jax_cnn_benchmark(
        flax_model, variables, JaxWordPiece(jax_make_test_vocab(WORDS)), 32,
        stride)
    iou, miou = evaluate_benchmark(
        _Loader(), port, WordPieceTokenizer(make_test_vocab(WORDS)), CLASSES,
        4, "pascal_voc", input_size=32, bilateral_stride=4, max_length=12,
        device="cpu")
    np.testing.assert_array_equal(iou, np.asarray(jiou))
    assert miou == float(jmiou)
    # a decode built for another grid step refuses the CNN's tokens
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    decode = make_seg_decode_fn(num_classes=len(CLASSES), image_size=32,
                                patch_size=16, top_cls_num=4,
                                bilateral_stride=4)
    dense = torch.nn.functional.normalize(torch.randn(2, 16, 16), dim=-1)
    with pytest.raises(ValueError, match="16 tokens for a 2x2 grid"):
        decode(dense, dense[:, 0], torch.nn.functional.normalize(
            torch.randn(len(CLASSES), 16), dim=-1),
            torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
