"""The device's idle share of the traced segment of training: one minus
the union of its device activity over the segment, in percent."""

from pbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
