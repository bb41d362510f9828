"""Plain reference of a dense GQA decoder, in float32 with TF32 off.

Written from the configuration's sizes alone (``perfbench/configs``): an
embedding, ``n_layers`` pre-norm blocks (RMSNorm, causal self-attention
with rotary positions and grouped KV heads, RMSNorm, SwiGLU), a final
RMSNorm and the output head (the embedding, transposed, where tied).  It
imports nothing of the program.  Rotary angles are taken in float64 and
the query scale is the exact hd^-0.5.

Everything runs in blocks so that it fits beside nothing else on the card:
attention over blocks of query rows, the head over blocks of positions,
training over blocks of sequences with each (layer, block) recomputed in
the backward pass.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 with one scale a tensor (amax / 448) before a
float32 product, the gradient passing straight through the rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8_MAX = 448.0


def set_precision() -> None:
    """Full float32 products: no TF32, no reduced-precision reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fq(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def _ops(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return _fq
    raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")


def to_f32(w: dict) -> dict:
    return {k: v.detach().to(torch.float32, copy=True) for k, v in w.items()}


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x, theta: float, fraction: float = 1.0):
    """Rotate the first ``fraction`` of each head's dimensions in two halves
    by angle position·theta^(-2i/rot); x (B, T, heads, hd), position t at
    row t."""
    T, hd = x.shape[1], x.shape[-1]
    rot = int(hd * fraction)
    i = torch.arange(0, rot, 2, dtype=torch.float64, device=x.device)
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           * theta ** (-i / rot))
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                      x[..., rot:]], dim=-1)


def attention(q, k, v, *, q_block: int, precision: str, grad: bool):
    """Causal softmax attention; q (B, T, H, hd), k and v (B, T, KV, hd);
    head h reads KV head h // (H / KV).  Each block of ``q_block`` query
    rows sees keys 0 .. its last row; with ``grad`` each block is
    recomputed in the backward pass."""
    fq = _ops(precision)
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5

    def block(qb, kb, vb, lo):
        n, e = qb.shape[1], kb.shape[1]
        qg = qb.reshape(B, n, KV, G, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", fq(qg), fq(kb)) * scale
        keep = (torch.arange(lo, lo + n, device=q.device)[:, None]
                >= torch.arange(e, device=q.device)[None, :])
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", fq(p), fq(vb))
        return o.reshape(B, n, H, hd)

    outs = []
    for lo in range(0, T, q_block):
        hi = min(lo + q_block, T)
        args = (q[:, lo:hi], k[:, :hi], v[:, :hi], lo)
        outs.append(checkpoint(block, *args, use_reentrant=False) if grad
                    else block(*args))
    return torch.cat(outs, dim=1)


def layer(w: dict, l: int, c: dict, x, *, precision: str, grad: bool,
          q_block: int = 512, kv_out: list | None = None):
    """Block ``l`` on x (B, T, d); with ``kv_out`` its rotated keys and its
    values are appended there."""
    fq = _ops(precision)
    d, H, KV, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    B, T, _ = x.shape

    def mm(a, b):
        return fq(a) @ fq(b)

    h = rmsnorm(x, w["norm1.scale"][l], c["norm_eps"])
    q = mm(h, w["attn.wq"][l].reshape(d, H * hd)).reshape(B, T, H, hd)
    k = mm(h, w["attn.wk"][l].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    v = mm(h, w["attn.wv"][l].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    if c["qkv_bias"]:
        q, k, v = q + w["attn.bq"][l], k + w["attn.bk"][l], v + w["attn.bv"][l]
    frac = c.get("rotary_fraction", 1.0)
    q, k = rope(q, c["rope_theta"], frac), rope(k, c["rope_theta"], frac)
    if kv_out is not None:
        kv_out.append((k, v))
    o = attention(q, k, v, q_block=q_block, precision=precision, grad=grad)
    x = x + mm(o.reshape(B, T, H * hd), w["attn.wo"][l].reshape(H * hd, d))
    h = rmsnorm(x, w["norm2.scale"][l], c["norm_eps"])
    return x + mm(F.silu(mm(h, w["mlp.wg"][l])) * mm(h, w["mlp.wu"][l]),
                  w["mlp.wd"][l])


def head_matrix(w: dict, c: dict):
    """(d, V) output projection."""
    return w["embed.table"].T if c["tie_embeddings"] else w["lm_head"]


def hidden(w: dict, c: dict, tokens, *, precision: str, grad: bool,
           kv_out: list | None = None):
    """Final-normed hidden states (B, T, d) of ``tokens`` (B, T); with
    ``grad`` every layer is recomputed in the backward pass."""
    x = w["embed.table"][tokens]
    for l in range(c["n_layers"]):
        if grad:
            x = checkpoint(layer, w, l, c, x, precision=precision, grad=True,
                           use_reentrant=False)
        else:
            x = layer(w, l, c, x, precision=precision, grad=False,
                      kv_out=kv_out)
    return rmsnorm(x, w["final_norm.scale"], c["norm_eps"])


# ------------------------------------------------------------------ prefill
@torch.no_grad()
def prefill(w: dict, c: dict, tokens, *, precision: str = "f32",
            pos_block: int = 1024):
    """-> (hidden (B, T, d), [(k, v) of every layer], a function giving
    the logits (B, n, V) of positions lo:hi)."""
    kv: list = []
    x = hidden(w, c, tokens, precision=precision, grad=False, kv_out=kv)
    fq = _ops(precision)
    head = head_matrix(w, c)

    def logits(lo, hi):
        return fq(x[:, lo:hi]) @ fq(head)

    return x, kv, logits


# ----------------------------------------------------------------- training
def _chunk_nll(xc, head, tc, mc, precision):
    fq = _ops(precision)
    logp = torch.log_softmax(fq(xc) @ fq(head), dim=-1)
    return -(torch.gather(logp, -1, tc[..., None])[..., 0] * mc).sum()


def ssl_terms(pooled_logits, labels, label_mask, W, gamma, kappa):
    """Eq. 3 over one group: (supervised mean over the labelled, graph
    term) from pooled logits (b, V), labels and mask (b,), W (b, b)."""
    logp = torch.log_softmax(pooled_logits, dim=-1)
    p = torch.exp(logp)
    sup = -(logp.gather(-1, labels[:, None])[:, 0] * label_mask).sum()
    sup = sup / torch.clamp(label_mask.sum(), min=1.0)
    cross = -(W * (p @ logp.T)).sum()
    ent = -(p * logp).sum(-1)
    graph = gamma * cross - ((kappa + gamma * W.sum(-1)) * ent).sum()
    return sup, graph


def loss_and_grads(w: dict, c: dict, batch: dict, *, gamma: float,
                   kappa: float, precision: str = "f32", seq_block: int = 4,
                   chunk: int = 2048):
    """Next-token CE over every position plus the graph-SSL objective of
    the sequences' pooled output distributions; sets ``.grad`` of every
    leaf of ``w`` and returns the loss terms as floats."""
    tokens, targets = batch["tokens"], batch["targets"]
    mask = batch["loss_mask"]
    B, T = tokens.shape
    head = head_matrix(w, c)
    for t in w.values():
        t.grad = None
    xs = [hidden(w, c, tokens[s:s + seq_block], precision=precision,
                 grad=True) for s in range(0, B, seq_block)]
    x = torch.cat(xs, dim=0)
    nll = 0.0
    for b in range(B):
        for lo in range(0, T, chunk):
            nll = nll + checkpoint(_chunk_nll, x[b, lo:lo + chunk], head,
                                   targets[b, lo:lo + chunk],
                                   mask[b, lo:lo + chunk], precision,
                                   use_reentrant=False)
    ce = nll / torch.clamp(mask.sum(), min=1.0)
    fq = _ops(precision)
    pooled = fq(x.mean(dim=1)) @ fq(head)
    sup, graph = ssl_terms(pooled, batch["seq_labels"],
                           batch["seq_label_mask"], batch["W"], gamma, kappa)
    total = ce + sup + graph / B
    total.backward()
    return {"loss/ce": ce.item(), "ssl/supervised": sup.item(),
            "ssl/graph": graph.item(), "loss/total": total.item()}


@torch.no_grad()
def adagrad(w: dict, accum: dict, lr: float, eps: float = 1e-8) -> None:
    """G += g²; p −= lr·g / (√G + eps), every leaf."""
    for k, p in w.items():
        g = p.grad
        accum[k].add_(g * g)
        p.sub_(lr * g / (torch.sqrt(accum[k]) + eps))
