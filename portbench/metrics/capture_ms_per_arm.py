"""capture_ms_per_arm: the program's own log of each arm's CUDA-graph
capture (``EngineRun.capture_log``: the eager warm-up rounds and the
capture, host clock) over the captures the window made, in ms."""


def read(ctx):
    caps = ctx.counters.get("captures") or []
    if not caps:
        return None
    return 1e3 * sum(c["warmup_s"] + c["capture_s"] for c in caps) / len(caps)
