"""Device time of everything but the products and the port's own CUDA
kernels a step (attention tiles, norms, RoPE, elementwise, copies),
from the profiler's kernel intervals in the traced window."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    v = ctx["trace"].group_s().get("other")
    return 1e3 * v / ctx["units"] if v else None
