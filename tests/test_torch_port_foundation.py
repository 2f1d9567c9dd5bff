"""PyTorch port (simseg_tpu_torch): package guards and the small modules
held against their JAX-package counterparts on the same numpy inputs.

Tolerances: integer and string results must be equal; float results of
the same f32 arithmetic in a different order get rtol 1e-6.
"""

import ast
import hashlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from simseg_tpu.data.tokenizer import make_test_vocab as jax_make_test_vocab
from simseg_tpu.data.transforms import normalize_images as jax_normalize
from simseg_tpu.ops.attention import multi_head_attention as jax_mha
from simseg_tpu.ops.attention import padding_bias as jax_padding_bias
from simseg_tpu.ops.pooling import avg_pool as jax_avg_pool
from simseg_tpu.ops.pooling import l2_normalize as jax_l2
from simseg_tpu.ops.pooling import topk_pool as jax_topk_pool
from simseg_tpu.utils.metrics import intersect_and_union as jax_iu
from simseg_tpu.utils.metrics import miou_from_totals as jax_miou
from simseg_tpu.utils.prompts import IMAGENET_TEMPLATES
from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.data.transforms import normalize_images
from simseg_tpu_torch.ops import crf_fused, crf_pallas, cuda_build, flash_attention
from simseg_tpu_torch.ops.attention import multi_head_attention, padding_bias
from simseg_tpu_torch.ops.pooling import avg_pool, l2_normalize, topk_pool
from simseg_tpu_torch.utils import prompts
from simseg_tpu_torch.utils.metrics import intersect_and_union, miou_from_totals

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "simseg_tpu_torch")
_FORBIDDEN = ("jax", "flax", "simseg_tpu")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


# ------------------------------------------------------------------ guards

def test_port_imports_leave_jax_and_simseg_tpu_out():
    """A fresh interpreter that imports every module of the port has no
    jax, flax or simseg_tpu in sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_covers_every_port_module():
    """The guard imports the modules found on disk, the token-merging,
    int8 and serving modules among them."""
    mods = _port_modules()
    assert {"simseg_tpu_torch.ops.tome", "simseg_tpu_torch.ops.quant",
            "simseg_tpu_torch.models.vit", "simseg_tpu_torch.tasks.seg_eval",
            "simseg_tpu_torch.models.linear_prob",
            "simseg_tpu_torch.tasks.linear_prob.config",
            "simseg_tpu_torch.tasks.linear_prob.train",
            "simseg_tpu_torch.serving",
            "simseg_tpu_torch.tools.export_serving"} <= set(mods)


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(r, f), REPO)
     for r, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py", "tests/test_torch_port_kernels.py"]))
def test_no_port_file_imports_jax(path):
    assert not set(_imported_roots(os.path.join(REPO, path))) & set(_FORBIDDEN)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_crf_wrapper_refuses_cuda_tensor_without_library(monkeypatch):
    """With the kernel library missing, a CUDA tensor must raise — never be
    sent down the plain path."""
    def missing():
        raise OSError("libcrf_mean_field.so: cannot open shared object file")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(crf_fused, "_library", missing)
    monkeypatch.setattr(crf_fused, "mean_field_fused_plain", plain)
    du = torch.zeros(1, 2, 16, 16).as_subclass(_CudaLooking)
    rgb = torch.zeros(1, 16, 16, 3).as_subclass(_CudaLooking)
    launches = crf_fused.LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        crf_fused.mean_field_fused(du, rgb, stride=4)
    assert crf_fused.LAUNCHES == launches


def _missing_library():
    raise OSError("lib.so: cannot open shared object file")


def _no_plain(*a, **k):
    raise AssertionError("fell back to the plain version")


def test_flash_wrapper_refuses_cuda_tensor_without_library(monkeypatch):
    monkeypatch.setattr(flash_attention, "_library", _missing_library)
    monkeypatch.setattr(flash_attention, "flash_mha_plain", _no_plain)
    q, k, v = (torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
               .as_subclass(_CudaLooking) for _ in range(3))
    launches = flash_attention.LAUNCHES
    with pytest.raises(OSError, match="cannot open shared object"):
        flash_attention.flash_mha(q, k, v)
    assert flash_attention.LAUNCHES == launches


def test_bilateral_wrapper_refuses_cuda_tensor_without_library(monkeypatch):
    monkeypatch.setattr(crf_pallas, "_library", _missing_library)
    monkeypatch.setattr(crf_pallas, "bilateral_matvec_plain", _no_plain)
    feat = torch.zeros(1, 16, 5).as_subclass(_CudaLooking)
    q = torch.ones(1, 16, 1).as_subclass(_CudaLooking)
    launches = crf_pallas.LAUNCHES
    for fn, args in ((crf_pallas.bilateral_matvec_batched, (feat, q)),
                     (crf_pallas.bilateral_matvec, (feat[0], q[0]))):
        with pytest.raises(OSError, match="cannot open shared object"):
            fn(*args)
    assert crf_pallas.LAUNCHES == launches


def test_kernel_libraries_are_named_by_their_source_hash(monkeypatch, tmp_path):
    """Each .so is built once per source version, under its own name, and
    a build that exists is not redone. The name hashes the source and, for
    the attention kernels, the Hopper header they include."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", _no_plain)
    header = os.path.join(cuda_build.CSRC, "hopper_sm90.cuh")
    for name in ("crf_mean_field", "flash_attention", "flash_attention_bwd",
                 "bilateral_matvec"):
        src = os.path.join(cuda_build.CSRC, f"{name}.cu")
        h = hashlib.sha256(open(src, "rb").read())
        if name.startswith("flash_attention"):
            h.update(b"hopper_sm90.cuh\0" + open(header, "rb").read())
        digest = h.hexdigest()[:12]
        built = tmp_path / f"lib{name}-{digest}.so"
        built.write_bytes(b"")
        assert cuda_build.build_library(name) == str(built)


# --------------------------------------------------------- data and utils

def test_prompt_templates_equal():
    assert prompts.IMAGENET_TEMPLATES == IMAGENET_TEMPLATES
    assert len(prompts.openai_imagenet_template("dog")) == 80


@pytest.mark.parametrize("text", [
    "a photo of a dog.", "Itap of my CAT!", "the [MASK] of a tree-frog",
    "café, naïve: résumé", "unknownword zzz"])
def test_tokenizer_matches_jax(text):
    words = ["a", "photo", "of", "the", "dog", "cat", "tree", "frog", "itap",
             "my"]
    assert make_test_vocab(words) == jax_make_test_vocab(words)
    ours = WordPieceTokenizer(make_test_vocab(words))
    ref = JaxWordPiece(jax_make_test_vocab(words))
    for max_length in (6, 25):
        assert ours([text, text.upper()], max_length=max_length) == ref(
            [text, text.upper()], max_length=max_length)


def test_normalize_images_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        normalize_images(torch.from_numpy(img)).numpy(),
        np.asarray(jax_normalize(jnp.asarray(img))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_classes", [4, 6])
def test_intersect_and_union_matches_jax(num_classes):
    """Labels include ignore (255) and ids >= num_classes, which both
    versions leave out of the histograms."""
    rng = np.random.default_rng(num_classes)
    pred = rng.integers(0, num_classes, (20, 30)).astype(np.int32)
    label = rng.integers(0, 7, (20, 30)).astype(np.int32)
    label[:3] = 255
    ours = intersect_and_union(torch.from_numpy(pred), torch.from_numpy(label),
                               num_classes, 255)
    ref = jax_iu(jnp.asarray(pred), jnp.asarray(label), num_classes, 255)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ti, tu = ours[0].double().numpy(), ours[1].double().numpy()
    iou, miou = miou_from_totals(ti, tu)
    jiou, jmiou = jax_miou(ti, tu)
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou


# ------------------------------------------------------- pooling, attention

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 9])
def test_topk_pool_matches_jax(masked, k):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    mask = np.ones((3, 7), np.int32)
    mask[0, 2:] = 0
    m_t = torch.from_numpy(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    np.testing.assert_allclose(
        topk_pool(torch.from_numpy(x), k, m_t).numpy(),
        np.asarray(jax_topk_pool(jnp.asarray(x), k, m_j)), rtol=1e-6, atol=1e-6)


def test_avg_pool_and_l2_normalize_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.int32)
    for m_t, m_j in ((None, None), (torch.from_numpy(mask), jnp.asarray(mask))):
        np.testing.assert_allclose(
            avg_pool(torch.from_numpy(x), m_t).numpy(),
            np.asarray(jax_avg_pool(jnp.asarray(x), m_j)), rtol=1e-6, atol=1e-7)
    y = np.concatenate([x[0], np.zeros((1, 4), np.float32)])
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(y)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_matches_jax(with_bias):
    rng = np.random.default_rng(3)
    b, t, h, hd = 2, 6, 2, 4
    q, k, v = (rng.normal(size=(b, t, h * hd)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[1, 4:] = 0
    bias_t = padding_bias(torch.from_numpy(mask)) if with_bias else None
    bias_j = jax_padding_bias(jnp.asarray(mask)) if with_bias else None
    if with_bias:
        np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    ours = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), h,
                                bias_t)
    ref = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), h, bias_j,
                  use_flash="never")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_label_bank_copy_matches_root():
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank

    root = open(os.path.join(REPO, "data", "label_category",
                             "pascal_voc.txt")).read().split()
    assert load_label_bank("pascal_voc") == root
    assert len(root) == 21
