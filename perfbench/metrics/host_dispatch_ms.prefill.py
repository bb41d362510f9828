"""Host time from a request's start to the return of ``serve_lm.prefill``
(before anything waits for the device), mean over the traced requests."""
import statistics


def read(ctx):
    if ctx.get("kind") != "prefill" or not ctx.get("dispatch_s"):
        return None
    return 1e3 * statistics.mean(ctx["dispatch_s"])
