"""PyTorch port (simseg_tpu_torch): the segmentation loader against the JAX
package's ``build_seg_valid_loader`` (``simseg_tpu/data/datasets.py:146-253,
:495-505``), batch for batch, on a 3-scene VOC-layout fixture from
``tools/seg_parity.py:build_fixture`` (palette scenes stored as PNG under
``.jpg`` names, palette-PNG labels of 320-511 px).

Bar: bit-equal ``image``, ``mask_label``, ``mask_h`` / ``mask_w``, the
ragged last batch, ``len`` and ``max_label_size``, with the identity
resize at 288 px, a real bilinear resize and a bicubic resize + centre
crop, and the same files in the PASCAL-Context and COCO-Stuff layouts.
Beside them: JPEG files decoded on the CPU (PIL, as JAX), a
``torch.distributed``-free shard of one, and an error inside a decode
thread reaching the consumer.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.data.datasets import build_seg_valid_loader as jax_loader
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.datasets import (DataLoader, SegDataset,
                                            build_seg_valid_loader)
from simseg_tpu_torch.data.transforms import build_transforms
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn
from tools.seg_parity import build_fixture

torch.set_num_threads(1)

TRANSFORMS = {
    "identity288": (["resize"], 288, 224),
    "resize200": (["resize"], 200, 224),
    "bicubic_crop": (["resize_bicubic", "center_crop"], 150, 128),
}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segdata"))
    build_fixture(root, 3, 8, 0, 288)
    return root


def _cfgs(root, ops, size, crop, batch=2):
    argv = [f"data.data_path={root}/", f"data.batch_size_val={batch}",
            "data.num_workers=2", f"transforms.valid_transforms={ops!r}",
            f"transforms.resize.size={size}",
            f"transforms.resize_bicubic.size={size}",
            f"transforms.center_crop.size={crop}"]
    return (jax_update_cfg(jax_task_cfg_init_fn, None, argv=argv,
                           target=jax_new_base_cfg()),
            update_cfg(task_cfg_init_fn, None, argv=argv, target=new_base_cfg()))


def _assert_loaders_equal(jl, pl):
    assert len(pl) == len(jl)
    assert pl.batch_size == jl.batch_size
    assert pl.dataset.max_label_size() == jl.dataset.max_label_size()
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == len(jl)
    for want, got in zip(jb, pb):
        assert sorted(got) == sorted(want)
        assert isinstance(got["image"], torch.Tensor)
        assert got["image"].device.type == "cpu"
        np.testing.assert_array_equal(got["image"].numpy(), want["image"])
        for key in set(want) - {"image"}:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    return jb


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_loader_matches_jax(fixture_root, name):
    jcfg, cfg = _cfgs(fixture_root, *TRANSFORMS[name])
    batches = _assert_loaders_equal(jax_loader(jcfg, "pascal_voc"),
                                    build_seg_valid_loader(cfg, "pascal_voc",
                                                           device="cpu"))
    # 3 scenes at 2 a batch: the last batch is ragged, and the labels'
    # sizes differ within a batch, so they arrive padded with their sizes
    assert [b["image"].shape[0] for b in batches] == [2, 1]
    assert "mask_h" in batches[0]


def test_jpeg_images_match_jax(fixture_root, tmp_path):
    """The fixture's images re-encoded as real JPEG (PIL, quality 90): the
    port's CPU decode is PIL's, so the batches stay bit-equal."""
    root = str(tmp_path / "jpeg")
    shutil.copytree(fixture_root, root)
    img_dir = os.path.join(root, "VOCdevkit", "VOC2012", "JPEGImages")
    for f in os.listdir(img_dir):
        path = os.path.join(img_dir, f)
        with Image.open(path) as im:
            rgb = im.convert("RGB").resize((375, 250))
        rgb.save(path, format="JPEG", quality=90)
    jcfg, cfg = _cfgs(root, *TRANSFORMS["identity288"])
    _assert_loaders_equal(jax_loader(jcfg, "pascal_voc"),
                          build_seg_valid_loader(cfg, "pascal_voc", device="cpu"))


def test_shards_split_the_split(fixture_root):
    _, cfg = _cfgs(fixture_root, *TRANSFORMS["identity288"], batch=1)
    ds = SegDataset(cfg, "pascal_voc", build_transforms(cfg), device="cpu")
    shards = [DataLoader(ds, 1, shard_index=i, shard_count=2) for i in (0, 1)]
    assert [len(s) for s in shards] == [2, 1]
    seen = [b["image"] for s in shards for b in s]
    full = [b["image"] for b in DataLoader(ds, 1)]
    assert all(torch.equal(a, b) for a, b in zip(seen, [full[0], full[2], full[1]]))


def test_decode_error_reaches_the_consumer(fixture_root, tmp_path):
    root = str(tmp_path / "broken")
    shutil.copytree(fixture_root, root)
    img_dir = os.path.join(root, "VOCdevkit", "VOC2012", "JPEGImages")
    with open(os.path.join(img_dir, sorted(os.listdir(img_dir))[1]), "wb") as f:
        f.write(b"not an image")
    _, cfg = _cfgs(root, *TRANSFORMS["identity288"])
    # no reader of the port claims it: PIL's error, as JAX's loader raises
    with pytest.raises(OSError, match="cannot identify image file"):
        list(build_seg_valid_loader(cfg, "pascal_voc", device="cpu"))


@pytest.mark.parametrize("name", ["pascal_context", "coco_stuff"])
def test_other_layouts_match_jax(fixture_root, tmp_path, name):
    """The fixture's files rearranged into the PASCAL-Context and
    COCO-Stuff layouts (COCO-Stuff: names from a glob of the image
    directory, labels ``<name>_labelTrainIds.png``): the same batches as
    JAX's loader, and the split's size."""
    voc = os.path.join(fixture_root, "VOCdevkit", "VOC2012")
    with open(os.path.join(voc, "ImageSets", "Segmentation", "val.txt")) as f:
        names = [line.rstrip() for line in f]
    root = str(tmp_path / name)
    if name == "pascal_context":
        base = os.path.join(root, "VOCdevkit", "VOC2010")
        img_dir = os.path.join(base, "JPEGImages")
        label_dir = os.path.join(base, "SegmentationClassContext")
        os.makedirs(os.path.join(base, "ImageSets", "SegmentationContext"))
        with open(os.path.join(base, "ImageSets", "SegmentationContext",
                               "val.txt"), "w") as f:
            f.write("\n".join(names))
        suffix = ""
    else:
        base = os.path.join(root, "coco_stuff164k")
        img_dir = os.path.join(base, "images", "val2017")
        label_dir = os.path.join(base, "annotations", "val2017")
        suffix = "_labelTrainIds"
    os.makedirs(img_dir)
    os.makedirs(label_dir)
    for n in names:
        shutil.copy(os.path.join(voc, "JPEGImages", f"{n}.jpg"), img_dir)
        shutil.copy(os.path.join(voc, "SegmentationClass", f"{n}.png"),
                    os.path.join(label_dir, f"{n}{suffix}.png"))
    jcfg, cfg = _cfgs(root, *TRANSFORMS["resize200"])
    loader = build_seg_valid_loader(cfg, name, device="cpu")
    assert len(loader.dataset) == len(names)
    _assert_loaders_equal(jax_loader(jcfg, name), loader)
