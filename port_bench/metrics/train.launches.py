"""Device kernels a train step, from the traced segment."""

from pbench.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
