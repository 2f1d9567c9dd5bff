"""PyTorch port (simseg_tpu_torch): multi-scale and sliding-window dense
inference, position-embedding resampling and the bilinear resize, held
against the JAX package on the same parameters and numpy inputs (CPU, f32).

Bars: position-embedding resampling and bilinear resize within 1e-6 /
1e-5 (the same float32 matrices and filters, summed in another order); the
ViT at another input size within 1e-4 (tests/test_torch_port_models.py);
through the whole forward, candidate ids and validity equal and pred on
>= 99.9% of pixels (tests/test_torch_port_seg.py), histograms equal where
pred is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import simseg_tpu.tasks.seg_eval as jax_seg_eval
import simseg_tpu_torch.tasks.seg_eval as port_seg_eval
from simseg_tpu.config import new_base_cfg, update_cfg
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.ops.interpolate_pe import interpolate_pos_embed as jax_interp
from simseg_tpu.tasks.clip.config import task_cfg_init_fn
from simseg_tpu_torch.checkpoint.convert import flax_params_to_state_dict
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed, resize_bilinear
from simseg_tpu_torch.ops.seg_decode import shortlist
from tests.test_models import tiny_clip
from tests.test_seg_decode import _norm

torch.set_num_threads(1)

PIXEL_BAR = 0.999
WORDS = ["a", "photo", "of", "the", "background", "dog", "cat", "bird",
         "tree", "car"]
CLASSES = ["background", "dog", "cat", "bird", "tree", "car"]


# ------------------------------------------------------------ resampling

@pytest.mark.parametrize("old,new", [(18, 36), (14, 18), (4, 6)])
def test_interpolate_pos_embed_matches_jax(old, new):
    rng = np.random.default_rng(old * 100 + new)
    pe = rng.normal(size=(1, 1 + old * old, 24)).astype(np.float32)
    ours = interpolate_pos_embed(torch.from_numpy(pe), new * new)
    ref = np.asarray(jax_interp(jnp.asarray(pe), new * new))
    assert ours.shape == (1, 1 + new * new, 24)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours.numpy()[:, 0], pe[:, 0])


def test_interpolate_pos_embed_same_grid_is_identity():
    pe = torch.randn(1, 1 + 16, 8)
    assert interpolate_pos_embed(pe, 16) is pe


BILINEAR = [(36, 18), (32, 24), (27, 18), (18, 36), (16, 40)]


@pytest.mark.parametrize("size_in,size_out", BILINEAR)
def test_resize_bilinear_matches_jax(size_in, size_out):
    rng = np.random.default_rng(size_in + size_out)
    x = rng.normal(size=(2, size_in, size_in, 5)).astype(np.float32)
    ours = resize_bilinear(torch.from_numpy(x), size_out, size_out).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x),
                                      (2, size_out, size_out, 5), "bilinear"))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size_in,size_out", [(36, 18), (32, 24)])
def test_resize_without_antialias_misses_jax_downsampling(size_in, size_out):
    """Why the flag is there: plain bilinear sampling is not what
    jax.image.resize computes when it downsamples."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, size_in, size_in, 4)).astype(np.float32)
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                          size=(size_out, size_out), mode="bilinear",
                          align_corners=False, antialias=False)
    ref = np.asarray(jax.image.resize(jnp.asarray(x),
                                      (1, size_out, size_out, 4), "bilinear"))
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-2


# ------------------------------------------------------------------ models

def _models(img_size=32):
    flax_model = tiny_clip(img_size=img_size)
    dummy = {
        "image": jnp.zeros((1, img_size, img_size, 3)),
        "input_ids": jnp.zeros((1, 12), jnp.int32),
        "attention_mask": jnp.ones((1, 12), jnp.int32),
    }
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0), dummy))
    port = CLIPModel(image_tag="vit_test", img_size=img_size,
                     text_tag="bert_test", projection_dim=16, image_k=3)
    port.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return flax_model, params, port.eval()


@pytest.fixture(scope="module")
def models32():
    return _models(32)


@pytest.fixture(scope="module")
def models16():
    return _models(16)


@pytest.mark.parametrize("size", [24, 48])
def test_vit_off_size_matches_flax(models32, size):
    flax_model, params, port = models32
    rng = np.random.default_rng(size)
    images = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    ref = flax_model.apply(params, jnp.asarray(images),
                           method=lambda m, im: m.forward_image_tokens(im))
    with torch.no_grad():
        ours = port.forward_image_tokens(torch.from_numpy(images))
    assert ours.shape == (2, 1 + (size // 8) ** 2, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# ----------------------------------------------------------- seg forward

def _cfg(argv):
    return update_cfg(task_cfg_init_fn, None, argv=[
        "model.max_length=12", "transforms.input_size=32",
        "seg_eval.bilateral_stride=4"] + argv, target=new_base_cfg())


def _inputs(seed=0, b=2, canvas=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8)
    tb = _norm(rng.normal(size=(len(CLASSES), 16))).astype(np.float32)
    labels = np.full((b, canvas, canvas), 255, np.int32)
    labels[:, :40, :48] = rng.integers(0, len(CLASSES), (b, 40, 48))
    return images, tb, labels, np.array([40, 33]), np.array([48, 29])


def _capturing(monkeypatch, module, store):
    """Patch ``module.make_seg_decode_fn`` so that the decode records the
    (dense, pooled) features it is given."""
    real = module.make_seg_decode_fn

    def make(**kw):
        decode = real(**kw)

        def wrapped(dense, pooled, *rest):
            store.append((np.array(dense), np.array(pooled)))
            return decode(dense, pooled, *rest)
        return wrapped
    monkeypatch.setattr(module, "make_seg_decode_fn", make)


CASES = {
    # name -> (JAX argv, port keywords, tower size)
    "scales_075_125": (["seg_eval.scales=[1.0,0.75,1.25]"],
                       dict(scales=(1.0, 0.75, 1.25)), 32),
    "scales_1_2": (["seg_eval.scales=[1.0,2.0]"], dict(scales=(1.0, 2.0)), 32),
    "scale_05_only": (["seg_eval.scales=[0.5]"], dict(scales=(0.5,)), 32),
    "window_16_8": (["seg_eval.window={'size': 16, 'stride': 8}"],
                    dict(window_size=16, window_stride=8), 16),
    "window_and_scales": (["seg_eval.window={'size': 16, 'stride': 8}",
                           "seg_eval.scales=[1.0,2.0]"],
                          dict(window_size=16, window_stride=8,
                               scales=(1.0, 2.0)), 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_seg_forward_matches_jax(name, models32, models16, monkeypatch):
    argv, kw, tower = CASES[name]
    flax_model, params, port = models32 if tower == 32 else models16
    cfg = _cfg(argv)
    images, tb, labels, gt_h, gt_w = _inputs()
    ji, ju, jpred = jax_seg_eval.make_seg_forward(
        flax_model, cfg, num_classes=6, top_cls_num=4, canvas=64, patch_size=8,
        return_pred=True)(params, jnp.asarray(images), jnp.asarray(tb),
                          jnp.asarray(labels), jnp.asarray(gt_h),
                          jnp.asarray(gt_w))
    fwd = port_seg_eval.make_seg_forward(
        port, num_classes=6, top_cls_num=4, canvas=64, input_size=32,
        bilateral_stride=4, patch_size=8, return_pred=True, device="cpu", **kw)
    i, u, pred = fwd(*(torch.from_numpy(a) for a in
                       (images, tb, labels, gt_h, gt_w)))

    jax_feats, port_feats = [], []
    _capturing(monkeypatch, jax_seg_eval, jax_feats)
    _capturing(monkeypatch, port_seg_eval, port_feats)
    jax_seg_eval.make_seg_predict(flax_model, cfg, 6, 4, patch_size=8)(
        params, jnp.asarray(images), jnp.asarray(tb))
    port_seg_eval.make_seg_predict(
        port, 6, 4, input_size=32, bilateral_stride=4, patch_size=8,
        device="cpu", **kw)(torch.from_numpy(images), torch.from_numpy(tb))
    (jdense, jpooled), (dense, pooled) = jax_feats[0], port_feats[0]
    np.testing.assert_allclose(dense, jdense, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pooled, jpooled, atol=1e-4, rtol=1e-4)
    (idx, _, valid), (jidx, _, jvalid) = (
        shortlist(torch.from_numpy(p), torch.from_numpy(tb), 4, 4)
        for p in (pooled, jpooled))
    assert torch.equal(idx, jidx) and torch.equal(valid, jvalid)

    agree = (pred.numpy() == np.asarray(jpred)).mean()
    assert agree >= PIXEL_BAR, agree
    if agree == 1.0:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    else:
        flipped = int((pred.numpy() != np.asarray(jpred)).sum())
        assert np.abs(i.numpy() - np.asarray(ji)).sum() <= 2 * flipped
        assert np.abs(u.numpy() - np.asarray(ju)).sum() <= 2 * flipped


# ------------------------------------------------------------ evaluation

class _Loader:
    """Two batches of 2, the second ragged (1 image); labels of
    ``label_size`` pixels, which the dataset reports up front."""

    batch_size = 2

    def __init__(self, label_size=40):
        self.label_size = label_size
        self.dataset = self

    def max_label_size(self):
        return self.label_size, self.label_size - 8

    def __iter__(self):
        for seed, b in ((1, 2), (2, 1)):
            rng = np.random.default_rng(seed)
            images = rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8)
            h, w = self.label_size, self.label_size - 8
            labels = rng.integers(0, len(CLASSES), (b, h, w)).astype(np.int32)
            yield {"image": images, "mask_label": labels,
                   "mask_h": [h] * b, "mask_w": [w] * b}


@pytest.mark.parametrize("label_size", [40, 520])
def test_evaluate_benchmark_multiscale_matches_jax(models32, label_size):
    """scales=[1.0, 2.0]; at 520 px the labels exceed VOC's 512 canvas and
    both versions raise it to 576 before the first batch."""
    flax_model, params, port = models32
    cfg = _cfg(["seg_eval.scales=[1.0,2.0]"])
    jiou, jmiou = jax_seg_eval.evaluate_benchmark(
        _Loader(label_size), flax_model, params, cfg,
        JaxWordPiece(jax_make_test_vocab(WORDS)), CLASSES, 4, "pascal_voc")
    iou, miou = port_seg_eval.evaluate_benchmark(
        _Loader(label_size), port, WordPieceTokenizer(make_test_vocab(WORDS)),
        CLASSES, 4, "pascal_voc", input_size=32, bilateral_stride=4,
        max_length=12, scales=(1.0, 2.0), device="cpu")
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou


@pytest.mark.parametrize("need,canvas", [(40, 512), (512, 512), (513, 576),
                                         (520, 576), (641, 704)])
def test_label_canvas_prescan(need, canvas):
    assert port_seg_eval.label_canvas(_Loader(need), "pascal_voc") == canvas
    assert port_seg_eval.label_canvas([], "pascal_voc") == 512
    assert port_seg_eval.label_canvas([], "unknown") == 640
