"""Pretraining pairs over the whole window: every step's batch over the
window's seconds, the window closed by a synchronisation (host clock)."""


def read(ctx):
    return ctx.window["items"] / ctx.window["seconds"]
