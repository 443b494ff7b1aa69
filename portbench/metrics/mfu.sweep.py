"""mfu.sweep: the §V arm-round's least time at the f32 peak (every product
is f32 with TF32 off), over its measured time: the arm-rounds of the
window over the window's host seconds.

Operations an arm-round needs, counted from the shapes (no recomputation:
the capture's warm-up rounds are not counted, their time is):
- every worker's forward and backward over its K samples:
  2·K·(d_in·h + h·c) forward, 2·K·(d_in·h + 2·h·c) backward (no gradient
  of the input);
- the held-out evaluations' forward, a share per round;
- the compression's projection, 2·U·n·S·D_c;
- BIHT: the first back-projection and, per iteration, one projection and
  one back-projection, 2·n·S·D_c each."""


def ops_per_arm_round(cfg, rounds):
    d_in, h, c = cfg["d_in"], cfg["d_hidden"], cfg["n_classes"]
    U, K = cfg["workers"], cfg["samples_per_worker"]
    d = d_in * h + h + h * c + c
    n, s, dc = -(-d // cfg["chunk"]), cfg["measure"], cfg["chunk"]
    n_evals = len({t for t in range(rounds) if t % cfg["eval_every"] == 0}
                  | {rounds - 1})
    mlp = U * K * (2 * (d_in * h + h * c) + 2 * (d_in * h + 2 * h * c))
    evals = n_evals * cfg["eval_samples"] * 2 * (d_in * h + h * c) / rounds
    proj = 2 * U * n * s * dc
    biht = (2 * cfg["biht_iters"] + 1) * 2 * n * s * dc
    return mlp + evals + proj + biht


def read(ctx):
    if not ctx.units or ctx.window_s <= 0:
        return None
    rounds = ctx.cell.traffic["rounds"]
    least = ops_per_arm_round(ctx.cell.config, rounds) \
        / ctx.peaks["f32_flops_per_s"]
    return 100.0 * ctx.units * least / ctx.window_s
