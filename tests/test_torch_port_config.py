"""PyTorch port (simseg_tpu_torch): the config system and the CLIP default
bank, held against the JAX package's (``simseg_tpu.config``,
``simseg_tpu/tasks/clip/config.py``). Trees must be equal, key for key and
value for value; so must the errors the strict merge raises.
"""

import os
import subprocess
import sys

import pytest

import chip_smoke
from simseg_tpu import config as jax_config
from simseg_tpu.tasks.clip import config as jax_clip_config
from simseg_tpu_torch import config
from simseg_tpu_torch.tasks.clip import config as clip_config
from simseg_tpu_torch.utils.collections import AttrDict, OpenDict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["configs/clip/simseg.vit-b.yaml", "configs/clip/simseg.vit-s.yaml"]
OVERRIDES = ["data.batch_size=64", "optim.lr.init=3e-4",
             "model.pool.loda.image_k=7", "transforms.input_size=576",
             "optim.param_group_rules={'vit': {'regex': 'image_encoder', "
             "'param': {'lr': 1e-5}}}", "seg_eval.scales=[1.0,2.0]",
             "data.valid_name=[pascal_voc,coco]", "dist.bf16=false"]


def _port_tree(yaml_path, argv):
    return config.update_cfg(clip_config.task_cfg_init_fn, yaml_path, argv,
                             preprocess_fn=clip_config.update_clip_config,
                             target=config.new_base_cfg())


def _jax_tree(yaml_path, argv):
    return jax_config.update_cfg(
        jax_clip_config.task_cfg_init_fn, yaml_path, argv,
        preprocess_fn=jax_clip_config.update_clip_config,
        target=jax_config.new_base_cfg())


@pytest.mark.parametrize("with_overrides", [False, True])
@pytest.mark.parametrize("yaml_path", YAMLS)
def test_yaml_tree_matches_jax(yaml_path, with_overrides):
    argv = OVERRIDES if with_overrides else []
    path = os.path.join(REPO, yaml_path)
    ours, ref = _port_tree(path, argv), _jax_tree(path, argv)
    assert ours.to_dict() == ref.to_dict()
    assert ours.is_immutable and ours.model.is_immutable
    assert type(ours.optim.param).__name__ == type(ref.optim.param).__name__


def test_defaults_without_a_file_match_jax():
    assert _port_tree(None, []).to_dict() == _jax_tree(None, []).to_dict()


@pytest.mark.parametrize("argv,error", [
    (["model.no_such_key=1"], KeyError),
    (["data.batch_size"], ValueError),
    (["seg_eval.bilateral_stride=[4]"], TypeError),
])
def test_bad_overrides_raise_as_jax(argv, error):
    with pytest.raises(error):
        _port_tree(None, argv)
    with pytest.raises(error):
        _jax_tree(None, argv)


def test_strict_merge_rejects_unknown_yaml_keys(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("model:\n  not_a_key: 1\n")
    with pytest.raises(KeyError, match="model.not_a_key"):
        _port_tree(str(path), [])


def test_chip_smoke_overrides_reproduce_the_yaml():
    """The training slice's override list (no YAML on the card) gives the
    tree of simseg.vit-b.yaml in the sections it claims, at 576 px."""
    ours = _port_tree(None, list(chip_smoke.TRAIN_OVERRIDES)
                      + list(chip_smoke.TRAIN_SLICE))
    ref = _port_tree(os.path.join(REPO, YAMLS[0]), list(chip_smoke.TRAIN_SLICE))
    for section in ("optim", "model", "loss"):
        assert ours[section].to_dict() == ref[section].to_dict(), section
    assert ours.dist.bf16 is True and ref.dist.bf16 is True
    for tree in (ours, ref):
        assert (tree.transforms.input_size,
                tree.transforms.random_resize_crop.size, tree.data.batch_size,
                tree.data.train_steps, tree.epoch) == (576, 576, 32, 12, 1)


def test_attrdict_freezes_recursively():
    d = AttrDict(a={"b": [{"c": 1}]}, o=OpenDict(x=1))
    assert isinstance(d.a, AttrDict) and isinstance(d.a.b[0], AttrDict)
    d.set_immutable(True)
    with pytest.raises(AttributeError):
        d.a.b[0].c = 2
    with pytest.raises(AttributeError):
        d.new = 1
    assert d.o.x == 1 and d.to_dict() == {"a": {"b": [{"c": 1}]}, "o": {"x": 1}}


def test_yaml_is_imported_only_for_a_file():
    code = (
        "import sys\n"
        "import simseg_tpu_torch.tasks.clip.train, simseg_tpu_torch.core.runner\n"
        "from simseg_tpu_torch import config\n"
        "from simseg_tpu_torch.tasks.clip import config as c\n"
        "config.update_cfg(c.task_cfg_init_fn, None, ['epoch=2'], "
        "target=config.new_base_cfg())\n"
        "print('yaml' in sys.modules)\n"
        f"config.update_cfg(c.task_cfg_init_fn, {YAMLS[0]!r}, [], "
        "target=config.new_base_cfg())\n"
        "print('yaml' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]


def test_main_stops_until_the_loader_is_ported():
    """The entry point parses as the JAX one does. The loader is ported
    (the run itself: tests/test_torch_port_train_cli.py), so what stops
    ``main`` now is a missing ``--vocab_file``, before any data is read,
    or a runner other than JAX's two."""
    from simseg_tpu_torch.tasks.clip import train

    target = config.new_base_cfg()
    train.parse_args(["--cfg", os.path.join(REPO, YAMLS[0]), "epoch=3"],
                     target=target)
    assert target.epoch == 3 and target.is_immutable
    assert target.ckpt.dir == os.path.join("./output", "simseg_eval")
    with pytest.raises(SystemExit, match="--vocab_file is required"):
        train.main(["--cfg", os.path.join(REPO, YAMLS[0]), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="runner 'linear'"):
        train.main(["--cfg", os.path.join(REPO, YAMLS[0]), "--vocab_file",
                    "v.txt", "--device", "cpu", "runner.name=linear"])
