"""Linear-probe task default config bank (port of
``simseg_tpu/tasks/linear_prob/config.py``).

Parity: reference ``simseg/tasks/linear_prob/config.py:9-186`` — the CLIP
bank plus ``model.classifier.num_classes``, the ViT's ``only_cls_token``
and the mixup keys, with the defaults of ``configs/linear_prob/
imagenet.yaml`` (LARS at batch 16,384, a frozen encoder).
"""

from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn as _clip_init
from simseg_tpu_torch.tasks.clip.config import update_clip_config as update_linear_config  # noqa: F401
from simseg_tpu_torch.utils.collections import AttrDict, OpenDict


def task_cfg_init_fn(cfg: AttrDict) -> None:
    _clip_init(cfg)

    cfg.runner.name = "linear_prob"
    cfg.data.name = "imagenet_local"
    cfg.data.train_name = ["imagenet"]
    cfg.data.valid_name = ["imagenet"]

    cfg.model.name = "linear_prob"
    cfg.model.classifier = AttrDict()
    cfg.model.classifier.num_classes = 1000

    cfg.model.image_encoder.vit = AttrDict()
    cfg.model.image_encoder.vit.only_cls_token = True
    cfg.model.image_encoder.trainable = False

    cfg.loss.name = "CE"

    cfg.mixup = AttrDict()
    cfg.mixup.enable = False
    cfg.mixup.alpha = 0.2

    cfg.optim.name = "LARS"
    cfg.optim.param = OpenDict(momentum=0.9, weight_decay=0.0,
                               trust_coefficient=0.001)
    cfg.optim.lr.name = "cosine_schedule_with_warmup"
    cfg.optim.lr.init = 6.4
    cfg.optim.lr.warmup_proportion = 0.1
