"""PyTorch/CUDA port of ``simseg_tpu`` for NVIDIA Hopper (H100).

The JAX package ``simseg_tpu`` is the reference; this package mirrors its
module names (``models/vit.py`` here ports ``simseg_tpu/models/vit.py``)
and its public layouts (NHWC images, (B, N, D) tokens, (B, K, H, W) maps),
but imports neither JAX nor anything of ``simseg_tpu``.

Entry points take ``device=None``, which means CUDA: there is no silent CPU
fallback. Only an explicit ``device="cpu"`` runs on the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the rank's card, ``cuda:LOCAL_RANK`` (``cuda:0`` outside
    a ``torch.distributed`` launch, where ``LOCAL_RANK`` is unset);
    anything else as given.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    """
    if device is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0") or 0))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simseg_tpu_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain CPU path")
    return dev
