"""Model FLOPs of one prefill request (the forward, the head over every
position it returns) over the traced request time × the chip's bf16
peak."""


def read(ctx):
    peak = ctx.get("peaks")
    if ctx.get("kind") != "prefill" or peak is None or not ctx.get("unit_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["unit_s"] * peak["bf16_flops"])
