"""roofline.backproject.sweep: K4 (``kernels/backproject.py``,
x' = x + τ·rΦ) in the §V decode, as a share of its least time.

Each call at the §V shape: x (n_chunks, D_c), r (n_chunks, S_c), Φ
(S_c, D_c), x' (n_chunks, D_c), f32. Least time per call: the larger of
the bytes (each input read once, the output written once) over the HBM
rate and the f32 operations (2·n·S·D_c for rΦ, 2·n·D_c for the update)
over the f32 peak. The calls are the program's launch counter over the
profiled sweep (replays and capture warm-ups alike); the time is the
profiler's device time of every kernel whose name holds "backproject"."""
from portbench.harness import kernel_seconds


def geometry(cfg):
    d = (cfg["d_in"] * cfg["d_hidden"] + cfg["d_hidden"]
         + cfg["d_hidden"] * cfg["n_classes"] + cfg["n_classes"])
    return -(-d // cfg["chunk"]), cfg["measure"], cfg["chunk"]


def least_s(rows, s, dc, peaks):
    nbytes = 4 * (2 * rows * dc + rows * s + s * dc)
    flops = 2 * rows * s * dc + 2 * rows * dc
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flops_per_s"])


def read(ctx):
    t = kernel_seconds(ctx, "backproject")
    calls = ctx.counters.get("launches", {}).get("backproject", 0)
    if not t or not calls:
        return None
    n, s, dc = geometry(ctx.cell.config)
    return 100.0 * calls * least_s(n, s, dc, ctx.peaks) / t
