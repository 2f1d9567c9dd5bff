"""The benchmark's frozen arithmetic: the card's peaks and the towers' flop
counts, copied from the program's attribution tools (``tower_flops``) so
that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, dense rates without sparsity, at its 700-W limit
# (NVIDIA's data sheet)
BF16_FLOP_PER_S = 989e12


def tower_flops(t: int, d: int, depth: int, extra_macs: float = 0.0) -> float:
    """A transformer tower's forward flops at ``t`` tokens and width ``d``:
    per block 12 t d^2 multiply-adds (qkv, output projection, the 4d MLP)
    and 2 t^2 d (scores and context); ``extra_macs`` adds the patch
    embedding and the projections. Two flops a multiply-add."""
    per_block = 12 * t * d * d + 2 * t * t * d
    return 2.0 * (depth * per_block + extra_macs)


def clip_pair_train_flops(size: int, patch: int, d_img: int, depth_img: int,
                          tokens: int, d_txt: int, depth_txt: int,
                          proj_dim: int) -> float:
    """A training pair's flops: three times the forward (forward, and a
    backward of twice its work) of the image tower at ``size`` px with its
    patch embedding and one projection of the patch tokens, and of the text
    tower at ``tokens`` with one projection of every token."""
    n = (size // patch) ** 2
    img = tower_flops(n + 1, d_img, depth_img,
                      n * d_img * 3 * patch * patch + n * d_img * proj_dim)
    txt = tower_flops(tokens, d_txt, depth_txt, tokens * d_txt * proj_dim)
    return 3.0 * (img + txt)
