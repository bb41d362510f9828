"""Loop of the ``train_lm_ssl`` traffic kind: graph-SSL LM training.

Set-up makes the corpus and the weights from the seed, builds the LM
example's host pipeline over that corpus (bag-of-tokens features, k-NN
graph, meta-batch plan, neighbour sampler: ``examples.train_lm_ssl``'s
``build_data`` with the seed in place of its fixed 0) and drives one
training state (params, AdaGrad state) through ``followed_steps`` steps
of the window's own call and feed; the reference follows those steps.
The same state then runs the window: each step takes its batch from
``train_lm_ssl.batches`` (host assembly and the copy to the card) and
calls ``lm_train_step``; the window closes on a synchronise after its
last step.
"""
from __future__ import annotations

import time

from . import common, inputs
from .trace import Tracer

#: Faults a test or a calibration run can plant in the timed path.
FAULTS = ("state_unchanged", "half_batch", "token_altered")
KEPT = ("tokens", "targets", "W", "seq_labels", "seq_label_mask")


def pipeline(c: dict, t: dict, toks, topics, lmask, seed: int) -> dict:
    """The example's host pipeline over this corpus: what ``build_data``
    returns."""
    from repro_torch.api import AFFINITY
    from repro_torch.core import plan_meta_batches
    from repro_torch.core.metabatch import NeighborSampler
    from repro_torch.data import sequence_features

    s = c["ssl"]
    feats = sequence_features(toks, c["vocab_size"], dim=s["feature_dim"],
                              seed=0)
    graph = AFFINITY.get("knn_rbf")(feats, k=s["knn_k"])
    plan = plan_meta_batches(graph, batch_size=t["meta_batch"],
                             n_classes=s["plan_classes"], seed=seed)
    return {"toks": toks, "topics": topics, "graph": graph, "plan": plan,
            "sampler": NeighborSampler(plan.batch_edges, seed=seed),
            "label_mask": lmask}


def _step_fn(cfg, hyper, opt, lr, faults):
    from repro_torch.train.train_step import lm_grads, lm_train_step

    def step(params, state, batch):
        if "half_batch" in faults:
            # Rows lead tokens, targets and the loss mask; W and the SSL
            # labels carry the group axis first.
            h = batch["tokens"].shape[0] // 2
            batch = {k: v[:, :h, :h] if k == "W" else
                     v[:, :h] if k.startswith("seq_") else v[:h]
                     for k, v in batch.items()}
        if "state_unchanged" in faults:
            return lm_grads(params, batch, cfg=cfg, hyper=hyper,
                            pairwise="auto")[1]
        return lm_train_step(params, state, batch, cfg=cfg, hyper=hyper,
                             opt=opt, lr=lr, pairwise="auto")[2]
    return step


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float, strict: bool = True, faults=(),
        control: bool = False, setup=None) -> dict:
    """One run of a training cell -> {"metrics", "numbers", "attempted",
    "peak", "trace_ctx"}; with ``control`` also "control_numbers": the
    reference in float8 judged in the program's place."""
    import torch
    from repro_torch.core import SSLHyper
    from repro_torch.examples import train_lm_ssl
    from repro_torch.optim import adagrad

    from ..reference import compare
    from ..reference import train as ref_train

    common.check_faults(faults, FAULTS)
    setup = setup or common.SetUp(t_process)
    c, t = cell.config, cell.traffic
    cfg = common.program_config(c, strict=strict)
    V, T, L = c["vocab_size"], t["seq_len"], c["n_layers"]
    toks, topics = inputs.token_corpus(
        t["n_seqs"], T + 1, V, n_topics=t["n_topics"], zipf=t["zipf"],
        topic_share=t["topic_share"], topic_boost=t["topic_boost"],
        seed=seed)
    lmask = inputs.label_mask(t["n_seqs"], c["ssl"]["label_share"], seed)
    setup.mark("corpus")
    data = pipeline(c, t, toks, topics, lmask, seed)
    setup.mark("host pipeline")
    params = inputs.program_tree(inputs.make_weights(c, seed, device))
    common.sync(device)
    setup.mark("weights")
    opt = adagrad()
    state = opt.init(params)
    hyper = SSLHyper(gamma=c["ssl"]["gamma"], kappa=c["ssl"]["kappa"],
                     weight_decay=0.0)
    step = _step_fn(cfg, hyper, opt, t["lr"], set(faults))
    feed = train_lm_ssl.batches(data, t["meta_batch"], 1 << 62, device)

    def next_batch():
        b = next(feed)
        if "token_altered" in faults:
            b["tokens"][0, 7] = (b["tokens"][0, 7] + 1) % V
        return b

    # Set-up: the steps the reference follows, through the window's call.
    prog = {"losses": [], "w_blocks": []}
    kept = []
    last_s = 0.0
    for i in range(t["followed_steps"]):
        t0 = time.perf_counter()
        batch = next_batch()
        kept.append({k: batch[k].cpu() for k in KEPT})
        metrics = step(params, state, batch)
        common.sync(device)
        last_s = time.perf_counter() - t0
        prog["losses"].append({k: float(metrics[k])
                               for k in compare.LOSSES})
        prog["w_blocks"].append(kept[-1]["W"][0].double().numpy())
        common.log(f"followed step {i}: {last_s:.3f} s {prog['losses'][-1]}")
        if i == 0:
            prog["grad1"] = compare.slice_norms(
                common.flat_leaves(state["accum"]), L,
                fn=lambda name, a: torch.sqrt(a))
    w0 = inputs.make_weights(c, seed, device)
    prog["delta"] = compare.slice_norms(
        common.flat_leaves(params), L,
        fn=lambda name, p: p.float() - w0[name].float())
    del w0
    setup.mark("followed steps")
    setup.report()

    def steps(n, tracer):
        """n steps, then a synchronise -> (host seconds of each batch
        fetch, the window's seconds)."""
        fetch = []
        with tracer.window():
            t_start = time.perf_counter()
            for _ in range(n):
                with tracer.span("host_batch"):
                    tb = time.perf_counter()
                    batch = next_batch()
                    fetch.append(time.perf_counter() - tb)
                with tracer.span("step"):
                    step(params, state, batch)
            with tracer.span("sync"):
                common.sync(device)
            window_s = time.perf_counter() - t_start
        return fetch, window_s

    t_setup = time.perf_counter()
    ctx = None
    if trace:
        # Untraced steps first, for the host-clock metrics, then traced
        # ones, for the device's.
        from ..count import flops
        n = t["traced_steps"]
        fetch, window_s = steps(n, Tracer(False))
        tracer = Tracer(True)
        steps(n, tracer)
        ctx = {"kind": "train", "trace": tracer.read(), "units": n,
               "unit_s": window_s / n, "host_batch_s": fetch,
               "flops": flops.train_step_flops(c, 2 * t["meta_batch"], T),
               "config": c, "traffic": t}
        metrics = {}
        n *= 2
    else:
        n = max(1, int(seconds / max(last_s, 1e-3)))
        _, window_s = steps(n, Tracer(False))
        metrics = {"train_step_ms": 1e3 * window_s / n,
                   "setup_s": t_setup - t_process}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    common.log(f"window: {n} steps; {metrics}; peak {peak}")

    del params, state, feed, data
    common.free(device)
    n_ref = t["followed_steps"]
    refd = ref_train.follow(c, t, seed=seed, corpus=toks, topics=topics,
                            label_mask=lmask, batches=kept[:n_ref],
                            device=device)
    common.log(f"reference: {refd['losses']}")
    numbers, look = compare.train_numbers(prog, refd)
    common.log(f"look: {look}")
    out = {"metrics": metrics, "numbers": numbers, "look": look,
           "attempted": n, "peak": peak, "trace_ctx": ctx}
    if control:
        ctl = ref_train.follow(c, t, seed=seed, corpus=toks, topics=topics,
                               label_mask=lmask, batches=kept[:n_ref],
                               device=device, precision="fp8")
        out["control_numbers"], look = compare.train_numbers(ctl, refd)
        common.log(f"control look: {look}")
    return out
