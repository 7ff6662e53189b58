"""Set-up: seconds from the process's start to the window's start (host
clock): imports, the CUDA context, the kernels' build or load, the
inputs on the device and the one warm-up call."""


def read(ctx):
    return ctx.setup_s
