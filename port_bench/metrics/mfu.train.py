"""The whole step's share of the card's bf16 peak: three times the
forward flops of a pair (the image tower at the crop size, the text tower
at the caption length, the projections) for every pair of the window over
989 TFLOP/s times the window's seconds, in percent (host clock)."""

from pbench.readers import train_pair_flops
from pbench.yardstick import BF16_FLOP_PER_S


def read(ctx):
    flops = train_pair_flops(ctx) * ctx.window["items"]
    return 100.0 * flops / (BF16_FLOP_PER_S * ctx.window["seconds"])
