"""Host time of fetching one training batch from the LM example's
pipeline (``train_lm_ssl.batches``: neighbour sampling, the dense W block,
the copy to the card), mean over the traced steps, by the harness's own
span around the call."""
import statistics


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("host_batch_s"):
        return None
    return 1e3 * statistics.mean(ctx["host_batch_s"])
