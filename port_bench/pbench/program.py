"""The system under test, ``simseg_tpu_torch``, built as its entry points
build it: the config tree from the configuration's YAML (as JSON in the
configuration file) and the cell's overrides, the model from the tree,
and the benchmark's seeded weights loaded into it."""

from __future__ import annotations

import os
import tempfile
from typing import Sequence

import torch

from pbench.weights import make_state
from pbench_ref.clip import param_shapes


def config_tree(config: dict, overrides: Sequence[str]):
    """The program's frozen config tree: its task defaults, the YAML of
    ``config["program"]`` (written back as YAML to a temporary file: the
    program reads a file) merged strictly, then dotted ``overrides``."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.clip.config import (task_cfg_init_fn,
                                                    update_clip_config)

    import yaml

    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            yaml.safe_dump(config["program"], f)
        return update_cfg(task_cfg_init_fn, path, list(overrides),
                          preprocess_fn=update_clip_config,
                          target=new_base_cfg())
    finally:
        os.unlink(path)


def state(ctx):
    """The run's seeded weights on its device (the reference layout)."""
    return make_state(param_shapes(ctx.sizes), ctx.seed, ctx.device,
                      float(ctx.config["program"]["loss"]["temperature"]["value"]))


def model(ctx, cfg, weights):
    """``build_clip_model(cfg)`` on the run's device with ``weights``
    loaded strictly."""
    from simseg_tpu_torch.models.clip import build_clip_model

    with torch.device(ctx.device):
        m = build_clip_model(cfg)
    m.load_state_dict(weights, strict=True)
    return m
