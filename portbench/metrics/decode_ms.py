"""decode_ms: device ms a round between the zoo round's stage events
(the frozen stage clock on ``round_train``'s ``hook=``) that end in
"decode": IHT over every chunk row (K3, K4, K1)."""


def read(ctx):
    v = ctx.spans.get("stage_decode")
    return sum(v) / len(v) if v else None
