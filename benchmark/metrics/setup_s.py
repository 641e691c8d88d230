"""setup_s: process start to the first measured job (imports, the CUDA
context, kernels built or loaded, the scene rendered and handed over, the
warm-up jobs), host clock."""


def read(ctx):
    return ctx.setup_s
