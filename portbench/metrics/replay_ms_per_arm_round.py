"""replay_ms_per_arm_round: CUDA events around every ``run_chunk`` call
that captured nothing (the harness's wrapper, ``drivers/sweep.py``),
summed, over the arm-rounds those calls replayed."""


def read(ctx):
    ms = ctx.spans.get("replay_ms") or []
    n = ctx.counters.get("replay_rounds", 0)
    return sum(ms) / n if ms and n else None
