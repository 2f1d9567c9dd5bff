"""Set-up seconds: from the process's start to the first timed call
(imports, weights and inputs from the seed, the kernels built or loaded,
the class bank or the training object's first steps, the warm-up)."""


def read(ctx):
    return ctx.window["setup_s"]
