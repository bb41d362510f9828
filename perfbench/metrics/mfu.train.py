"""Model FLOPs of one training step (forward and backward, nothing
recomputed counted) over the traced step time × the chip's bf16 peak."""


def read(ctx):
    peak = ctx.get("peaks")
    if ctx.get("kind") != "train" or peak is None or not ctx.get("unit_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["unit_s"] * peak["bf16_flops"])
