"""Loop of the ``prefill_moe`` traffic kind: ``prefill_closed``'s closed
loop on a sparse MoE model (Mixtral's), served dropless.

Each request is ``batch`` prompts of ``prompt_len`` tokens drawn from the
seed; it calls ``serve_lm.prefill`` (every position's logits, the cache,
each MoE layer's routing record) and ``decode.sample_tokens`` on the last
position, and ends when the tokens are on the host.  Weights come from
``moe_inputs``; the program's config is its own ``mixtral-8x7b`` at the
file's ``n_layers``, held to the file's other sizes.

After the window the reference (``reference/moe_transformer.py``)
recomputes a seeded sample of the requests, routed as the program routed
them, and ``compare.PrefillJudge`` holds the program's logits and cache
to it; two numbers more are compared: ``dropped``, the assignments no
expert computed (the program's records), and ``route_miss``, the share
of the program's assignments outside the reference's own top k among
tokens whose routing is clear-cut (``moe_transformer.MARGIN``).  The
look (not compared) gives the first checked request's numbers against
the reference routed by itself.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from . import common, inputs, moe_inputs
from .prefill_closed import FAULTS as DENSE_FAULTS
from .trace import Tracer

#: Faults a test or a calibration run can plant: the dense loop's, and
#: the MoE layers on the capacity path (the reference's GShard dispatch,
#: which drops).
FAULTS = DENSE_FAULTS + ("capacity_drop",)

#: Sizes the configuration file states, by the program config's field.
SIZES = {"n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
         "n_kv_heads": "n_kv_heads", "head_dim": "hd", "d_ff": "moe_d_ff",
         "n_experts": "n_experts", "top_k": "top_k",
         "vocab_size": "vocab_size", "qkv_bias": "qkv_bias",
         "rope_theta": "rope_theta", "sliding_window": "sliding_window",
         "tie_embeddings": "tie_embeddings", "dtype": "dtype"}


def program_config(c: dict, *, strict: bool):
    """The program's config of ``c["arch"]`` at the file's ``n_layers``;
    ``strict`` fails unless it states the file's other sizes, otherwise
    (the CPU tests) the file's sizes replace the program's."""
    from repro_torch.configs import get_config
    base = dataclasses.replace(get_config(c["arch"]), n_layers=c["n_layers"])
    if not strict:
        fields = {f: c[k] for k, f in SIZES.items() if f != "hd"}
        return dataclasses.replace(base, head_dim=c["head_dim"],
                                   d_ff=c["d_ff"], **fields)
    got = {k: getattr(base, f) for k, f in SIZES.items()}
    want = {k: c[k] for k in SIZES}
    if got != want or not base.is_moe or base.moe_every != 1 \
            or base.activation != "swiglu" or base.norm != "rmsnorm":
        raise ValueError(f"{c['arch']}: the program's config {got} is not "
                         f"the configuration file's {want}")
    return base


def _request_fn(cfg, new_tokens: int, faults):
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm
    from repro_torch.serve.decode import sample_tokens

    def request(params, prompts):
        """-> (outputs, cache, (B,) device tokens), the host time at which
        the prefill returned."""
        p = prompts
        if "half_batch" in faults:
            h = prompts.shape[0] // 2
            p = prompts[:h].repeat(2, 1)[:prompts.shape[0]]
        if "capacity_drop" in faults:
            out, cache = tf.prefill(params, cfg, p,
                                    cache_len=p.shape[1] + new_tokens)
        else:
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
    """One run of a MoE prefill cell -> {"metrics", "numbers",
    "attempted", "peak", "trace_ctx", "look"}; with ``control`` also
    "control_numbers": the reference in float8 judged in the program's
    place on the same requests."""
    # A program without the dropless layer's kernels cannot serve the
    # cell: it fails here, before any weight is drawn.
    import repro_torch.kernels.moe  # noqa: F401

    from ..count import moe_flops

    common.check_faults(faults, FAULTS)
    setup = setup or common.SetUp(t_process)
    c, t = cell.config, cell.traffic
    cfg = program_config(c, strict=strict)
    request = _request_fn(cfg, t["new_tokens"], set(faults))
    setup.mark("program imports")
    B, T, V = t["batch"], t["prompt_len"], c["vocab_size"]
    params = moe_inputs.program_tree(moe_inputs.make_weights(c, seed, device))
    common.sync(device)
    setup.mark("weights")
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
    reach = (n_max if trace else
             max(1, min(n_max, int(0.8 * seconds / max(warm_s, 1e-3)))))
    rng = np.random.default_rng([seed, 2])
    sample = set(rng.choice(reach, size=min(t["checked_requests"], reach),
                            replace=False).tolist())
    kept = {}
    peak = common.Peak(device)

    def serve(first, last, tracer, seconds=math.inf):
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
               "flops": moe_flops.prefill_flops(c, B, T),
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
    numbers, look, ctl = _check(c, seed, device, kept, prompts,
                                t["new_tokens"], control)
    common.log("reference done")
    result = {"metrics": metrics, "numbers": numbers, "attempted": n,
              "peak": peak.value, "trace_ctx": ctx, "look": look}
    if control:
        result["control_numbers"] = ctl
    return result


class _Judge:
    """``compare.PrefillJudge`` and the two numbers of the MoE layers."""

    def __init__(self):
        from ..reference import compare
        self.prefill = compare.PrefillJudge()
        self.dropped = 0
        self.missed = self.considered = 0

    def request(self, out, kv, tok, meta, ref):
        _, ref_kv, ref_logits, info = ref
        self.prefill.request(out, kv, tok, meta, ref_kv, ref_logits)
        self.missed += info["missed"]
        self.considered += info["considered"]

    def numbers(self) -> dict:
        return dict(self.prefill.numbers(), dropped=self.dropped,
                    route_miss=self.missed / max(self.considered, 1))


def _program_outputs(out, cache, tok, n_layers):
    """(logits, [(k, v)], tokens, [(positions, valid)]) of a kept request."""
    layers = cache["layers"][0]
    return (out["logits"], [(layers.k[l], layers.v[l])
                            for l in range(n_layers)], tok,
            [(layers.positions[l], layers.valid[l])
             for l in range(n_layers)])


def _check(c, seed, device, kept, prompts, new_tokens, control):
    """-> (the numbers compared, the look, the control's numbers)."""
    from repro_torch.models.layers import moe

    from ..reference import moe_transformer as ref
    ref.set_precision()
    w = moe_inputs.make_weights(c, seed, device)
    L = c["n_layers"]
    judge, ctl_judge = _Judge(), _Judge() if control else None
    look = {}
    for i, (out, cache, tok) in sorted(kept.items()):
        routes = [r["experts"].reshape(prompts[i].shape + (-1,))
                  for r in out["moe"]]
        judge.dropped += sum(moe.dropped(r) for r in out["moe"])
        got = _program_outputs(out, cache, tok.to(device), L)
        judge.request(*got, ref.prefill(w, c, prompts[i], routes=routes))
        if not look:
            free = _Judge()
            free.request(*got, ref.prefill(w, c, prompts[i]))
            look = {"own_routes": free.numbers()}
        kept[i] = None
        del out, cache, got
        common.free(device)
        if control:
            ctl = _control_outputs(ref, w, c, prompts[i], new_tokens)
            ctl_judge.request(*ctl[:4], ref.prefill(w, c, prompts[i],
                                                    routes=ctl[4]))
            del ctl
            common.free(device)
    return (judge.numbers(), look,
            ctl_judge.numbers() if control else None)


def _control_outputs(ref, w, c, prompts, new_tokens):
    """The reference in float8 in the program's place: its logits, its
    keys and values padded to the program's ring, tokens, positions and
    its own routes."""
    import torch
    B, T = prompts.shape
    _, kv, logits, info = ref.prefill(w, c, prompts, precision="fp8")
    full = torch.cat([logits(lo, min(lo + 1024, T))
                      for lo in range(0, T, 1024)], dim=1)
    slots = max(T + new_tokens, c["sliding_window"] or 0)
    dev = prompts.device
    pos = torch.zeros(B, slots, dtype=torch.int32, device=dev)
    pos[:, :T] = torch.arange(T, device=dev, dtype=torch.int32)
    valid = torch.zeros(B, slots, dtype=torch.bool, device=dev)
    valid[:, :T] = True
    tok = torch.argmax(full[:, -1], dim=-1)
    return full, kv, tok, [(pos, valid)] * len(kv), info["routes"]
