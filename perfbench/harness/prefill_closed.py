"""Loop of the ``prefill_closed`` traffic kind: one client, closed loop.

Each request is ``batch`` prompts of ``prompt_len`` tokens drawn from the
seed (a pool made in set-up, so the window generates nothing).  The
client sends a request, waits for it and sends the next: the request
calls ``serve_lm.prefill`` (every position's logits and a cache of
``prompt_len + new_tokens`` slots) and ``decode.sample_tokens`` on the
last position (greedy), and ends when the tokens are on the host.  Its
time to first token runs from its start to then.  Set-up warms up the
cell's one shape on two requests of their own.

A sample of the window's requests, drawn from the seed, keeps its
outputs (the peak the run reports leaves them out); once the window has
closed the reference recomputes each of them and ``compare.PrefillJudge``
holds the program's outputs to it.
"""
from __future__ import annotations

import math
import time

import numpy as np

from . import common, inputs
from .trace import Tracer

#: Faults a test or a calibration run can plant in the timed path.
FAULTS = ("state_unchanged", "half_batch", "token_altered")


def _request_fn(cfg, new_tokens: int, faults):
    from repro_torch.serve import serve_lm
    from repro_torch.serve.decode import sample_tokens

    def request(params, prompts):
        """-> (outputs, cache, (B,) device tokens), the host time at which
        ``prefill`` returned."""
        p = prompts
        if "half_batch" in faults:
            h = prompts.shape[0] // 2
            p = prompts[:h].repeat(2, 1)[:prompts.shape[0]]
        out, cache = serve_lm.prefill(params, cfg, p, new_tokens)
        t_ret = time.perf_counter()
        if "state_unchanged" in faults:
            for kv in cache["layers"]:
                kv.k.zero_()
                kv.v.zero_()
        tok = sample_tokens(out["logits"][:, -1:], temperature=0.0)[:, 0]
        if "token_altered" in faults:
            tok = (tok + 1) % cfg.vocab_size
        return out, cache, tok, t_ret
    return request


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float, strict: bool = True, faults=(),
        control: bool = False, setup=None) -> dict:
    """One run of a prefill cell -> {"metrics", "numbers", "attempted",
    "peak", "trace_ctx"}; with ``control`` also "control_numbers": the
    reference in float8 judged in the program's place on the same
    requests."""
    from ..count import flops
    from ..reference import compare
    from ..reference import transformer as ref

    common.check_faults(faults, FAULTS)
    setup = setup or common.SetUp(t_process)
    c, t = cell.config, cell.traffic
    cfg = common.program_config(c, strict=strict)
    request = _request_fn(cfg, t["new_tokens"], set(faults))
    setup.mark("program imports")
    B, T, V = t["batch"], t["prompt_len"], c["vocab_size"]
    params = inputs.program_tree(inputs.make_weights(c, seed, device))
    common.sync(device)
    setup.mark("weights")
    # A traced run serves its requests twice over: untraced first, for the
    # host-clock metrics, then under the profiler, for the device's.
    n_max = (2 * t["traced_requests"] if trace
             else max(1, math.ceil(seconds / t["min_request_s"])))
    pool = inputs.prompts(n_max + 2, B, T, V, seed=seed, device=device)
    common.sync(device)
    setup.mark("prompt pool")
    warm_s = 0.0
    for i in (n_max, n_max + 1):
        t0 = time.perf_counter()
        out = request(params, pool[i])
        out[2].cpu()
        warm_s = time.perf_counter() - t0
        del out
        setup.mark(f"warm-up request {i - n_max + 1}")
    setup.report()
    # The requests whose outputs are checked: a draw from the seed among
    # those the window is sure to reach.
    reach = (n_max if trace else
             max(1, min(n_max, int(0.8 * seconds / max(warm_s, 1e-3)))))
    rng = np.random.default_rng([seed, 2])
    sample = set(rng.choice(reach, size=min(t["checked_requests"], reach),
                            replace=False).tolist())
    kept = {}
    peak = common.Peak(device)

    def serve(first, last, tracer, seconds=math.inf):
        """Requests first..last-1 back to back, none started after
        ``seconds`` -> (time to first token and dispatch time of each, the
        window's seconds)."""
        ttft, dispatch = [], []
        with tracer.window():
            t_start = time.perf_counter()
            for i in range(first, last):
                if i > first and time.perf_counter() - t_start >= seconds:
                    break
                with tracer.span("request"):
                    t0 = time.perf_counter()
                    with tracer.span("prefill"):
                        out, cache, tok, t_ret = request(params, pool[i])
                    with tracer.span("first_token"):
                        tok_host = tok.cpu()
                    t1 = time.perf_counter()
                ttft.append(t1 - t0)
                dispatch.append(t_ret - t0)
                if i in sample:
                    kept[i] = (out, cache, tok_host)
                    peak.keep(out, cache)
                del out, cache, tok
            window_s = time.perf_counter() - t_start
        return ttft, dispatch, window_s

    t_setup = time.perf_counter()
    ctx = None
    if trace:
        half = t["traced_requests"]
        ttft, dispatch, _ = serve(0, half, Tracer(False))
        tracer = Tracer(True)
        traced, _, _ = serve(half, n_max, tracer)
        n = len(ttft) + len(traced)
        ctx = {"kind": "prefill", "trace": tracer.read(), "units": len(traced),
               "unit_s": float(np.mean(ttft)), "dispatch_s": dispatch,
               "flops": flops.prefill_flops(c, B, T),
               "k11_launches": c["n_layers"], "batch": B, "prompt_len": T,
               "config": c, "traffic": t}
        metrics = {}
    else:
        ttft, dispatch, window_s = serve(0, n_max, Tracer(False), seconds)
        n = len(ttft)
        metrics = {"ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
                   "prefill_tokens_per_s": n * B * T / window_s,
                   "setup_s": t_setup - t_process}
    common.log(f"window: {n} requests; {metrics}; peak {peak.read()} "
               f"less {peak.held} bytes kept for the check")

    prompts = {i: pool[i].clone() for i in kept}
    del params, pool
    common.free(device)
    ref.set_precision()
    w = ref.to_f32(inputs.make_weights(c, seed, device))
    judge = compare.PrefillJudge()
    ctl_judge = compare.PrefillJudge() if control else None
    for i, (out, cache, tok) in sorted(kept.items()):
        _, ref_kv, ref_logits = ref.prefill(w, c, prompts[i])
        layers = cache["layers"][0]
        judge.request(out["logits"], [(layers.k[l], layers.v[l])
                                      for l in range(c["n_layers"])],
                      tok.to(device),
                      [(layers.positions[l], layers.valid[l])
                       for l in range(c["n_layers"])], ref_kv, ref_logits)
        if control:
            ctl_out = _control_outputs(ref, w, c, prompts[i], t["new_tokens"])
            ctl_judge.request(*ctl_out, ref_kv, ref_logits)
            del ctl_out
        del ref_kv, ref_logits
        kept[i] = None
        common.free(device)
    common.log("reference done")
    result = {"metrics": metrics, "numbers": judge.numbers(),
              "attempted": n, "peak": peak.value, "trace_ctx": ctx}
    if control:
        result["control_numbers"] = ctl_judge.numbers()
    return result


def _control_outputs(ref, w, c, prompts, new_tokens):
    """The reference in float8 in the program's place: its logits, its
    keys and values padded to the program's cache, positions, tokens."""
    import torch
    B, T = prompts.shape
    _, kv, logits = ref.prefill(w, c, prompts, precision="fp8")
    full = torch.cat([logits(lo, min(lo + 1024, T))
                      for lo in range(0, T, 1024)], dim=1)
    slots = T + new_tokens
    dev = prompts.device
    pos = torch.zeros(B, slots, dtype=torch.int32, device=dev)
    pos[:, :T] = torch.arange(T, device=dev, dtype=torch.int32)
    valid = torch.zeros(B, slots, dtype=torch.bool, device=dev)
    valid[:, :T] = True
    tok = torch.argmax(full[:, -1], dim=-1)
    return full, kv, tok, [(pos, valid)] * len(kv)
