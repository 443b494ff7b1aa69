"""setup_s: host seconds from the process's start to the window's start:
imports, the kernels' library (built on a checkout's first run), the
inputs made on the device, the engine or model, and the warm-up."""


def read(ctx):
    return ctx.setup_s
