"""roofline.cs_project.lm: the projections of ``kernels/cs_project.py`` in
the zoo round, as a share of their least time: K2's compression,
pack32(sign(xΦᵀ)) over every worker's chunk rows, and K3's IHT residual,
y − xΦᵀ over every chunk row per iteration.

The work a round needs: K2 reads each worker's f32 rows once and writes
S_c/32 words a row; K3 reads each row and its y once and writes its f32
residual; each call reads Φ once (the calls are the program's launch
counters over the traced rounds); 2·S_c·D_c operations a row. Least time:
the larger of the bytes over the HBM rate and the operations over the
f32 peak, over the profiler's device time of every kernel whose name
holds "cs_project"."""
from portbench.harness import kernel_seconds
from portbench.reference.zoo import Layout


def read(ctx):
    t = kernel_seconds(ctx, "cs_project")
    launches = ctx.counters.get("launches", {})
    calls = launches.get("cs_project", 0) + launches.get("cs_project_resid", 0)
    p = ctx.profile
    if not t or not calls or not p:
        return None
    mc = ctx.cell.config
    rows = Layout(mc, mc["model_parallel"], mc["chunk"],
                  mc["workers"] * mc["block_chunks"]).n_chunks
    s, dc = mc["measure"], mc["chunk"]
    k2 = p["units"] * mc["workers"] * rows
    k3 = p["units"] * mc["iht_iters"] * rows
    nbytes = (4 * (k2 * dc + k2 * (s // 32)) + 4 * (k3 * dc + 2 * k3 * s)
              + calls * 4 * s * dc)
    flops = (k2 + k3) * 2 * s * dc
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                flops / ctx.peaks["f32_flops_per_s"])
    return 100.0 * least / t
