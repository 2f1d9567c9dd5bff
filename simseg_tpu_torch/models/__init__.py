"""The towers, projections and CLIP model (port of ``simseg_tpu/models``).

JAX's public table (``simseg_tpu/models/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.models``
imports no submodule. Every JAX name has a counterpart.
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.models.{module}", name)
           for module, names in (
               ("bert", ("BERT_CONFIGS", "BertEncoder", "build_bert")),
               ("clip", ("CLIPModel", "PIPELINE", "build_clip_model")),
               ("projection", ("ComplexProjection", "SimpleProjection")),
               ("resnet", ("RESNET_CONFIGS", "ResNet", "build_resnet")),
               ("vit", ("VIT_CONFIGS", "VisionTransformer", "build_vit")),
           ) for name in names}
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
