"""Device time of cuBLAS/CUTLASS products a step, from the profiler's
kernel intervals in the traced window."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    v = ctx["trace"].group_s().get("matmul")
    return 1e3 * v / ctx["units"] if v else None
