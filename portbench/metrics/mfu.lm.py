"""mfu.lm: the zoo round's least time at each precision's peak, over its
measured time: the rounds of the window over the window's host seconds.

Operations a round needs, counted from the shapes (no recomputation: the
remat's second forward and the chunked loss's recomputed logits are not
counted): each worker's forward and backward (3x the forward) over its B
sequences of N image + T text positions, in the compute dtype at its
peak (bf16: 989 TFLOP/s): per position and layer 2·(d·(H + 2·KV)·hd +
H·hd·d + 3·d·d_ff) for the projections, per layer 4·H·hd·P(P+1)/2 for
causal attention over P positions, and 2·V·d per text position for the
tied output; and the f32 CS math at the f32 peak: the compression's
projection of every worker's chunk rows and the IHT's projection and
back-projection of every chunk row per iteration, 2·S_c·D_c a row
each."""
from portbench.reference.zoo import Layout

PEAK = {"bfloat16": "bf16_flops_per_s", "float32": "f32_flops_per_s"}


def ops(mc, tr):
    d, ff, V, L = mc["d_model"], mc["d_ff"], mc["vocab_size"], \
        mc["num_layers"]
    H, KV, hd = mc["num_heads"], mc["num_kv_heads"], mc["head_dim"]
    T = tr["text_len"]
    P = mc["num_image_tokens"] + T
    per_layer = P * 2 * (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff) \
        + 4 * H * hd * P * (P + 1) // 2
    fwd = L * per_layer + T * 2 * V * d
    model = 3 * fwd * tr["seqs_per_worker"] * mc["workers"]
    rows = Layout(mc, mc["model_parallel"], mc["chunk"],
                  mc["workers"] * mc["block_chunks"]).n_chunks
    cs = (mc["workers"] + 2 * mc["iht_iters"]) * rows * 2 * mc["measure"] \
        * mc["chunk"]
    return model, cs


def read(ctx):
    if not ctx.units or ctx.window_s <= 0:
        return None
    model, cs = ops(ctx.cell.config, ctx.cell.traffic)
    peak = ctx.peaks[PEAK[ctx.cell.config["compute_dtype"]]]
    least = model / peak + cs / ctx.peaks["f32_flops_per_s"]
    return 100.0 * ctx.units * least / ctx.window_s
