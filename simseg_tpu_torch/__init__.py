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

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simseg_tpu_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain CPU path")
    return dev
