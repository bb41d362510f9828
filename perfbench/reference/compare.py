"""The numbers that decide ``correct``: what the program produced, held
against the plain reference.  Each is compared with its limit in
``perfbench/limits/<workload>.json``."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

LOSSES = ("loss/ce", "ssl/supervised", "ssl/graph", "loss/total")

#: A leaf whose first reference gradient is under this share of the
#: median leaf's is nought to rounding (a key's bias under softmax): its
#: gradient and its change under AdaGrad are round-off alone, and neither
#: is compared.
STILL_LEAF = 1e-3


def slice_norms(named: dict, n_layers: int, fn=None) -> dict:
    """name[l] -> ‖fn(name, leaf)[l]‖ for stacked leaves (leading axis of
    ``n_layers``), name -> ‖fn(name, leaf)‖ for the others; in float32,
    one leaf at a time.  ``fn`` defaults to the leaf itself."""
    out = {}
    for name, t in named.items():
        v = (t if fn is None else fn(name, t)).float()
        if name.split(".")[0] in ("norm1", "attn", "norm2", "mlp"):
            norms = torch.linalg.vector_norm(v.reshape(n_layers, -1), dim=1)
            for l, x in enumerate(norms.tolist()):
                out[f"{name}[{l}]"] = x
        else:
            out[name] = float(torch.linalg.vector_norm(v))
        del v
    return out


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """max over leaves of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖),
    with the leaf that gives it."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        p = prog.get(k, math.nan)
        g = abs(p - ref[k]) / max(ref[k], med, 1e-30)
        if not g <= worst:
            worst, at = g, k
            if g != g:
                break
    return worst, at


def loss_gaps(prog: list, ref: list) -> list:
    """Per followed step, the largest relative gap of its loss terms."""
    return [max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6) for k in LOSSES)
            for p, r in zip(prog, ref)]


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(the numbers compared, what else the look needs) of a training
    cell.  ``prog``: the program's losses of each followed step, its
    batches' W blocks, its first gradient's and its change's per-leaf
    norms; ``ref``: what ``reference.train.follow`` returns.  Only the
    first step's losses are compared: AdaGrad's first step moves every
    weight by ±lr wherever |g| ≫ 1e-8, so the signs of gradients within
    round-off of 0 set the later steps' losses (see PERF.md)."""
    gaps = loss_gaps(prog["losses"], ref["losses"])
    w_rel = max(float(np.abs(pw - rw).max()) / max(float(np.abs(rw).max()),
                                                   1e-30)
                for pw, rw in zip(prog["w_blocks"], ref["w_blocks"]))
    g1 = ref["grad1"]
    med = statistics.median(g1.values())
    moving = {k for k, v in g1.items() if v >= STILL_LEAF * med}
    grad1 = worst_leaf_gap(prog["grad1"], g1, moving)
    delta = worst_leaf_gap(prog["delta"], ref["delta"], moving)
    numbers = {"rows_mismatch": ref["mismatch"], "w_rel": w_rel,
               "loss_rel": gaps[0], "grad1_gap": grad1[0],
               "delta_gap": delta[0]}
    look = {"loss_gap_by_step": gaps, "grad1_leaf": grad1[1],
            "delta_leaf": delta[1],
            "still_leaves": sorted(set(g1) - moving)}
    return numbers, look


class PrefillJudge:
    """Accumulates, request by request, the gaps between a prefill's
    outputs (logits (B, T, V), the cache's k and v of every layer, each
    sequence's greedy token) and the reference's.

    ``token_gap`` is read at every position, not only at the served
    token: there the token the program puts first (the greedy pick of its
    logits; the served token at the last position), by how far the
    reference's logit of it lies below the reference's best, in the
    row's standard deviations.  A widest gap over eight served tokens
    swings from seed to seed as far as the float8 control's does; over
    every position it holds still enough to tell the two apart
    (PERF.md)."""

    def __init__(self):
        self.logits_rel = 0.0
        self.kv_rel = 0.0
        self.token_gap = 0.0
        self.cache_mismatch = 0

    def request(self, logits, layers_kv, token, cache_meta, ref_kv,
                ref_logits, pos_block: int = 1024) -> None:
        """``logits`` the program's (B, T, V); ``layers_kv`` its [(k, v)]
        (B, slots, KV, hd) per layer; ``token`` (B,) its greedy tokens;
        ``cache_meta`` [(positions, valid)] per layer; ``ref_kv`` the
        reference's [(k, v)] (B, T, KV, hd); ``ref_logits(lo, hi)`` the
        reference's logits of positions lo:hi."""
        B, T, _ = logits.shape
        for (k, v), (rk, rv), (pos, valid) in zip(layers_kv, ref_kv,
                                                  cache_meta):
            for got, want in ((k, rk), (v, rv)):
                rel = (torch.linalg.vector_norm(got[:, :T].float() - want)
                       / torch.linalg.vector_norm(want))
                self.kv_rel = max(self.kv_rel, float(rel))
            slots = pos.shape[-1]
            want_pos = torch.arange(T, device=pos.device).expand(B, T)
            self.cache_mismatch += int((pos[:, :T] != want_pos).sum())
            self.cache_mismatch += int((~valid[:, :T]).sum())
            self.cache_mismatch += int(valid[:, T:slots].sum())
        num = den = 0.0
        for lo in range(0, T, pos_block):
            hi = min(lo + pos_block, T)
            r = ref_logits(lo, hi)
            got = logits[:, lo:hi]
            num += float(torch.sum((got.float() - r) ** 2))
            den += float(torch.sum(r * r))
            first = torch.argmax(got, dim=-1)
            if hi == T:
                first[:, -1] = token.long()
            picked = r.gather(-1, first[..., None])[..., 0]
            gap = (r.max(-1).values - picked) / r.std(-1)
            self.token_gap = max(self.token_gap, float(gap.max()))
            del r, got, first, picked, gap
        self.logits_rel = max(self.logits_rel, (num / den) ** 0.5)

    def numbers(self) -> dict:
        return {"cache_mismatch": self.cache_mismatch,
                "logits_rel": self.logits_rel, "kv_rel": self.kv_rel,
                "token_gap": self.token_gap}
