"""arm_rounds_per_s: every arm-round the window's sweeps completed over
the window's host seconds, captures, evaluations and the results'
gathering included (every sweep pays them)."""


def read(ctx):
    return ctx.units / ctx.window_s if ctx.window_s > 0 else None
