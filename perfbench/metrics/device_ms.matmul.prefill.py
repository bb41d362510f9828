"""Device time of cuBLAS/CUTLASS products a request, from the profiler's
kernel intervals in the traced window."""


def read(ctx):
    if ctx.get("kind") != "prefill":
        return None
    v = ctx["trace"].group_s().get("matmul")
    return 1e3 * v / ctx["units"] if v else None
