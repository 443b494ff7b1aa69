"""backward_ms: device ms a round between the zoo round's stage events
(the frozen stage clock on ``round_train``'s ``hook=``) that end in
"backward": every worker's forward and backward pass."""


def read(ctx):
    v = ctx.spans.get("stage_backward")
    return sum(v) / len(v) if v else None
