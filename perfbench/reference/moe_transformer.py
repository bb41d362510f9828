"""Plain reference of Mixtral-8x7B's decoder, in float32 with TF32 off.

Written from the paper (arXiv:2401.04088, "Mixtral of Experts": Table 1
and section 2.1) and the configuration's sizes alone; it imports nothing
of the program.  An embedding, ``n_layers`` pre-norm blocks and a final
RMSNorm before an untied head.  A block: RMSNorm; causal self-attention
with rotary positions on every head dimension and grouped KV heads
(``transformer.attention``, blocks of query rows); RMSNorm; the sparse
MoE FFN: router logits h·W_r in float32, their softmax, each token's
top ``top_k`` experts (a stable sort: ties to the lower id), weighted by
their probabilities renormalised over the chosen, each expert a SwiGLU
FFN over exactly the tokens routed to it, the weighted outputs summed.

Departures, each the port's config's and noted in the configuration file:
RMSNorm ε is ``norm_eps`` (1e-6; published 1e-5), and the attention has no
window (published; the port's 4096-token window masks nothing while a
prompt and its next token fit in it, so the reference does not model it).

``routes``: each layer's (B, T, k) expert ids to route by instead of the
reference's own choice (the program's, so that a near tie that bf16
rounding broke the other way is not judged as an error of the rest); the
weights are still the reference's probabilities of those experts,
renormalised.  Every layer also tallies how many of the given
assignments are among its own top k, over the tokens whose own k-th and
(k+1)-th probabilities lie more than :data:`MARGIN` apart.

Weights come in the configuration's dtype and are upcast one layer at a
time (16 layers in float32 would not fit beside anything on one card).
``precision="fp8"`` is the control, as in ``transformer``: every product's
operands rounded to float8 e4m3 with one scale a tensor, the router's
too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .transformer import _ops, attention, rmsnorm, rope, set_precision

__all__ = ["prefill", "set_precision", "LAYER_LEAVES", "MARGIN"]

#: A token's routing counts as clear-cut where its k-th and (k+1)-th
#: probabilities differ by more than this.
MARGIN = 1e-3

#: Leaves stacked over the layers on a leading axis.
LAYER_LEAVES = ("norm1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                "norm2.scale", "moe.router", "moe.wg", "moe.wu", "moe.wd")


def moe(lw: dict, c: dict, h, *, precision: str, routes=None,
        tally: dict | None = None):
    """The sparse MoE FFN of h (B, T, d) -> (y (B, T, d), the layer's own
    top-k ids (B, T, k))."""
    fq = _ops(precision)
    B, T, d = h.shape
    E, k = c["n_experts"], c["top_k"]
    hf = h.reshape(B * T, d)
    probs = torch.softmax(fq(hf) @ fq(lw["moe.router"]), dim=-1)
    ranked, own = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = own[:, :k] if routes is None else routes.reshape(B * T, k).long()
    if tally is not None and E > k:
        clear = ranked[:, k - 1] - ranked[:, k] > MARGIN
        agree = (ids[:, :, None] == own[:, None, :k]).any(-1)
        tally["considered"] += k * int(clear.sum())
        tally["missed"] += int((clear[:, None] & ~agree).sum())
    wts = probs.gather(1, ids)
    wts = wts / wts.sum(-1, keepdim=True)
    y = torch.zeros_like(hf)
    for e in range(E):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = fq(hf[tok])
        act = (F.silu(he @ fq(lw["moe.wg"][e]))
               * (he @ fq(lw["moe.wu"][e])))
        y.index_add_(0, tok, (fq(act) @ fq(lw["moe.wd"][e]))
                     * wts[tok, slot, None])
    return y.reshape(B, T, d), own[:, :k].reshape(B, T, k)


def layer(lw: dict, c: dict, x, *, precision: str, routes=None,
          tally: dict | None = None, kv_out: list | None = None,
          q_block: int = 512):
    """Block of float32 leaves ``lw`` on x (B, T, d) -> (x, its own top-k
    ids); with ``kv_out`` its rotated keys and its values are appended
    there."""
    fq = _ops(precision)
    d, H, KV, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    B, T, _ = x.shape

    def mm(a, b):
        return fq(a) @ fq(b)

    h = rmsnorm(x, lw["norm1.scale"], c["norm_eps"])
    q = mm(h, lw["attn.wq"].reshape(d, H * hd)).reshape(B, T, H, hd)
    k = mm(h, lw["attn.wk"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    v = mm(h, lw["attn.wv"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    if kv_out is not None:
        kv_out.append((k, v))
    o = attention(q, k, v, q_block=q_block, precision=precision, grad=False)
    x = x + mm(o.reshape(B, T, H * hd), lw["attn.wo"].reshape(H * hd, d))
    h = rmsnorm(x, lw["norm2.scale"], c["norm_eps"])
    y, own = moe(lw, c, h, precision=precision, routes=routes, tally=tally)
    return x + y, own


@torch.no_grad()
def prefill(w: dict, c: dict, tokens, *, precision: str = "f32",
            routes: list | None = None):
    """-> (hidden (B, T, d), [(k, v) of every layer], a function giving the
    logits (B, n, V) of positions lo:hi, {"routes": each layer's own top-k
    ids, "missed", "considered": the tally above}).  ``w`` holds the
    leaves by name (``perfbench.harness.moe_inputs``), in any dtype."""
    kv: list = []
    info = {"routes": [], "missed": 0, "considered": 0}
    x = w["embed.table"][tokens].float()
    for l in range(c["n_layers"]):
        lw = {name: w[name][l].float() for name in LAYER_LEAVES}
        x, own = layer(lw, c, x, precision=precision,
                       routes=None if routes is None else routes[l],
                       tally=info, kv_out=kv)
        info["routes"].append(own)
        del lw
    x = rmsnorm(x, w["final_norm.scale"].float(), c["norm_eps"])
    fq = _ops(precision)
    head = w["lm_head"].float()

    def logits(lo, hi):
        return fq(x[:, lo:hi]) @ fq(head)

    return x, kv, logits, info
