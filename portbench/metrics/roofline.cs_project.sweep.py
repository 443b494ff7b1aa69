"""roofline.cs_project.sweep: the projections of ``kernels/cs_project.py``
in the §V round, as a share of their least time: K2's compression,
sign(xΦᵀ) over every worker's chunks (U·n_chunks rows, one call a round),
and K3's BIHT residual, y − sign(xΦᵀ) over the n_chunks rows.

Least time per call: the larger of the bytes (x, Φ and for K3 y read
once, the f32 output written once) over the HBM rate and 2·rows·S·D_c
operations over the f32 peak. The calls are the program's launch
counters over the profiled sweep; the time is the profiler's device time
of every kernel whose name holds "cs_project"."""
from portbench.harness import kernel_seconds


def geometry(cfg):
    d = (cfg["d_in"] * cfg["d_hidden"] + cfg["d_hidden"]
         + cfg["d_hidden"] * cfg["n_classes"] + cfg["n_classes"])
    return -(-d // cfg["chunk"]), cfg["measure"], cfg["chunk"]


def least_s(rows, s, dc, with_y, peaks):
    nbytes = 4 * (rows * dc + s * dc + rows * s * (2 if with_y else 1))
    flops = 2 * rows * s * dc
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flops_per_s"])


def read(ctx):
    t = kernel_seconds(ctx, "cs_project")
    launches = ctx.counters.get("launches", {})
    k2, k3 = launches.get("cs_project", 0), launches.get("cs_project_resid", 0)
    if not t or not (k2 or k3):
        return None
    cfg = ctx.cell.config
    n, s, dc = geometry(cfg)
    least = (k2 * least_s(cfg["workers"] * n, s, dc, False, ctx.peaks)
             + k3 * least_s(n, s, dc, True, ctx.peaks))
    return 100.0 * least / t
