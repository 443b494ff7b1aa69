"""device_idle_pct.lm: 100 x (1 - busy / wall) for a zoo round, busy the
union of the intervals in which a kernel, copy or fill ran on the card
over the profiled stretch (torch.profiler tracing the device alone), a
unit's share, and wall the window's host seconds a unit: the profiler
stretches the host's part of the stretch it traces (PERF.md §3)."""


def read(ctx):
    p = ctx.profile
    if not p or not p["units"] or not ctx.units or ctx.window_s <= 0:
        return None
    busy = p["busy_s"] / p["units"]
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.units))
