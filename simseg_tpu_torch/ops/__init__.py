"""Kernels and tensor ops (port of ``simseg_tpu/ops``).

JAX's public table (``simseg_tpu/ops/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.ops`` builds
no CUDA source and imports no submodule. Every JAX name has a counterpart.
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.ops.{module}", name)
           for module, names in (
               ("attention", ("multi_head_attention", "padding_bias")),
               ("crf", ("dense_crf_batched", "dense_crf_batched_du",
                        "dense_crf_binary")),
               ("grad_rev", ("grad_reverse",)),
               ("interpolate_pe", ("bicubic_resize_2d",
                                   "interpolate_pos_embed")),
               ("losses", ("info_nce", "label_smoothing_ce", "mixup_nce",
                           "mse_embedding_loss", "soft_target_ce",
                           "symmetric_info_nce", "triplet_loss")),
               ("morphology", ("closing", "dilate", "erode",
                               "nearest_upsample")),
               ("pooling", ("avg_pool", "l2_normalize", "topk_pool")),
               ("seg_decode", ("make_seg_decode_fn",)),
               ("tome", ("bipartite_merge", "unmerge", "update_gather_map")),
           ) for name in names}
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
