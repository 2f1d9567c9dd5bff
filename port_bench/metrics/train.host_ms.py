"""The train step's host time: from the step's call to its return, the
mean over every step of the measured window (host clock; the window is
not traced)."""

from pbench.stats import mean


def read(ctx):
    return 1e3 * mean(ctx.window["host_s"])
