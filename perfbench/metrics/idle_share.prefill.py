"""Share of the traced window in which no kernel ran on the device:
1 − the union of the kernels' intervals over the window."""


def read(ctx):
    if ctx.get("kind") != "prefill":
        return None
    tr = ctx["trace"]
    if not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
