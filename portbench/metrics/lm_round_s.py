"""lm_round_s: the window's host seconds over the FL rounds it completed,
each round every worker's backward, compression, the MAC, the decode and
the update."""


def read(ctx):
    return ctx.window_s / ctx.units if ctx.units else None
