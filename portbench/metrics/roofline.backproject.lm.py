"""roofline.backproject.lm: K4 (``kernels/backproject.py``,
x' = x + τ·rΦ) in the zoo round's IHT decode, as a share of its least
time.

The work a round needs: per IHT iteration every chunk row read once
(x, f32 D_c), written once (x'), its residual read once (f32 S_c), and Φ
read once a call (the calls are the program's launch counter over the
traced rounds); 2·S_c·D_c + 2·D_c operations a row. Least time: the
larger of the bytes over the HBM rate and the operations over the f32
peak, over the profiler's device time of every kernel whose name holds
"backproject"."""
from portbench.harness import kernel_seconds
from portbench.reference.zoo import Layout


def read(ctx):
    t = kernel_seconds(ctx, "backproject")
    calls = ctx.counters.get("launches", {}).get("backproject", 0)
    p = ctx.profile
    if not t or not calls or not p:
        return None
    mc = ctx.cell.config
    rows = Layout(mc, mc["model_parallel"], mc["chunk"],
                  mc["workers"] * mc["block_chunks"]).n_chunks
    s, dc = mc["measure"], mc["chunk"]
    n = p["units"] * mc["iht_iters"] * rows
    nbytes = 4 * (2 * n * dc + n * s) + calls * 4 * s * dc
    flops = n * (2 * s * dc + 2 * dc)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                flops / ctx.peaks["f32_flops_per_s"])
    return 100.0 * least / t
