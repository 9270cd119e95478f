"""setup_s (host clock): process start to the end of the warm-up call,
whose shape is the window's (imports, the CUDA context, the problems,
the kernels' build or load, the first call)."""


def read(ctx):
    return ctx.setup_s
