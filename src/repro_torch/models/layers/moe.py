"""Mixture-of-Experts FFN: capacity-based token dispatch (GShard /
Switch) with the Switch load-balance loss, and the serving path's
dropless dispatch.

Port of ``repro/models/layers/moe.py``.  A float32 softmax router picks
each token's top-k experts (ties to the lower expert id, as
``jax.lax.top_k``: a stable descending sort); each assignment takes the
next free slot of its expert, counted by an exclusive cumsum of the
assignment one-hot within its dispatch group, and an assignment past the
expert's capacity is dropped.  The reference computes the expert products
outside any Pallas kernel, so they are batched products (``torch.bmm``)
over the stacked expert weights here; dispatch is a scatter into
(E·cap) slots and a gather back, with no loop over experts.

Groups: with ``dispatch_groups`` = G dividing the N tokens, each group of
N/G tokens dispatches on its own (the reference ``vmap``s over groups),
otherwise G = 1.  Capacity per group is ``int(max(1, round(n_g·k/E·
capacity_factor)))`` with Python's ``round`` (halves to even).  The G
groups' slots go through the experts in one product: row results do not
depend on each other.

Dropless (:func:`apply_moe_dropless`, the serving path's; the JAX
package has no such layer): the same router, and every assignment is
computed.  K12 (:func:`repro_torch.kernels.moe.moe_dispatch`) sorts the
assignments by expert on the device and gathers their rows; the expert
products run over exactly each expert's rows (:func:`expert_ffn_grouped`,
the groups' ends read on the device); K13 (``moe_combine``) adds each
token's weighted rows back in token order, in float32.  In bfloat16 on
the card nothing in the layer waits for the host.  :data:`DISPATCH`
names the two; training (``forward``) keeps capacity, and so does
``transformer.prefill`` unless its caller asks for ``"dropless"``, as
the serving entry points do.

``stats``: a list that the layer appends one record to, ``{"experts":
(N, k) expert ids, "rows": (E,) int32 assignments each expert computed}``,
kept on the device; :func:`dropped` reads a record's dropped assignments
(and waits for the device), so the caller reads them after the pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import spans
from ...kernels import moe as kmoe
from .common import activation_fn, variance_scaling

#: The layer's dispatches: GShard capacity (the JAX package's, training)
#: and dropless (serving).
DISPATCH = ("capacity", "dropless")


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, activation: str,
             dtype: torch.dtype = torch.float32, *, lead: tuple = (),
             device: str | torch.device | None = None) -> dict:
    """The reference's leaves: a float32 router (d, E) and expert weights
    (E, d, f) / (E, f, d); ``lead`` prepends stacking axes."""
    def w(shape, fan_in, dt=dtype):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dt,
                                device=device)

    p = {"router": w((d_model, n_experts), d_model, torch.float32),
         "wu": w((n_experts, d_model, d_ff), d_model),
         "wd": w((n_experts, d_ff, d_model), d_ff)}
    if activation == "swiglu":
        p["wg"] = w((n_experts, d_model, d_ff), d_model)
    return p


def _expert_ffn(p, h: torch.Tensor, activation: str) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d), one batched product per matrix."""
    if activation == "swiglu":
        return torch.bmm(F.silu(torch.bmm(h, p["wg"])) * torch.bmm(h, p["wu"]),
                         p["wd"])
    return torch.bmm(activation_fn(activation)(torch.bmm(h, p["wu"])),
                     p["wd"])


def route(p, xf: torch.Tensor, top_k: int):
    """xf (N, d) -> (probs (N, E), top_w (N, k) normalised, top_e (N, k)),
    the router in float32."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def groups_and_capacity(N: int, top_k: int, n_experts: int,
                        capacity_factor: float,
                        dispatch_groups: int) -> tuple[int, int]:
    """(G, cap): the reference's dispatch groups and capacity per group."""
    G = dispatch_groups if dispatch_groups and N % dispatch_groups == 0 else 1
    cap = int(max(1, round(N // G * top_k / n_experts * capacity_factor)))
    return G, cap


def slots(top_e: torch.Tensor, n_experts: int, cap: int):
    """top_e (G, A) expert of each assignment -> (slot (G, A), keep (G,
    A)): assignment a takes slot e·cap + (assignments to e before it in
    its group) when that count is under ``cap``, else the overflow slot
    E·cap (dropped)."""
    oh = F.one_hot(top_e, n_experts)                          # (G, A, E)
    before = torch.cumsum(oh, dim=1) - oh
    pos = torch.gather(before, 2, top_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, top_e * cap + pos, n_experts * cap)
    return slot, keep


def dropped(rec: dict) -> int:
    """Assignments of a ``stats`` record that no expert computed (reads
    the device)."""
    return rec["experts"].numel() - int(rec["rows"].sum())


def apply_moe(p, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              activation: str, dispatch_groups: int = 0,
              stats: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (y (B, T, d), the Switch load-balance loss, 0-d
    float32)."""
    B, T, d = x.shape
    E = p["router"].shape[-1]
    N = B * T
    xf = x.reshape(N, d)
    probs, top_w, top_e = route(p, xf, top_k)
    # Switch load-balance loss: E · Σ_e (dispatch fraction · mean prob).
    frac = F.one_hot(top_e, E).float().sum(1).mean(0) / top_k
    aux = E * torch.sum(frac * probs.mean(0))

    G, cap = groups_and_capacity(N, top_k, E, capacity_factor,
                                 dispatch_groups)
    A = N // G * top_k
    slot, keep = slots(top_e.reshape(G, A), E, cap)
    # Assignment a belongs to token a // k of its group.
    xin = xf.repeat_interleave(top_k, dim=0).reshape(G, A, d)
    g = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros((G, E * cap + 1, d))
    buf[g, slot] = xin                    # row E·cap takes the overflow
    h = buf[:, :-1].reshape(G, E, cap, d).transpose(0, 1).reshape(
        E, G * cap, d)
    out = _expert_ffn(p, h, activation).reshape(E, G, cap, d).transpose(
        0, 1).reshape(G, E * cap, d)
    out = torch.cat([out, out.new_zeros((G, 1, d))], dim=1)
    ya = out[g, slot]                                         # (G, A, d)
    wk = (top_w.reshape(G, A) * keep).to(ya.dtype)
    y = (ya * wk[..., None]).reshape(N, top_k, d).sum(1)
    if stats is not None:
        rows = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
            0, top_e.reshape(-1), keep.reshape(-1).to(torch.int32))
        stats.append({"experts": top_e, "rows": rows})
    return y.reshape(B, T, d), aux


def expert_ffn_grouped(p, xs: torch.Tensor, ends: torch.Tensor,
                       activation: str) -> torch.Tensor:
    """xs (R, d) rows in expert order, ``ends`` (E,) int32 the cumulative
    ends of the experts' rows on xs's device -> (R, d): each row through
    its expert's FFN.  Each product is one ``torch._grouped_mm``: on the
    card in bfloat16 a CUTLASS grouped GEMM that reads ``ends`` there; in
    float32 on the card the library reads them on the host (the tests'
    and the smoke's reduced configs only)."""
    def mm(a, w):
        return torch._grouped_mm(a, w, offs=ends)

    if activation == "swiglu":
        return mm(F.silu(mm(xs, p["wg"])) * mm(xs, p["wu"]), p["wd"])
    return mm(activation_fn(activation)(mm(xs, p["wu"])), p["wd"])


def apply_moe_dropless(p, x: torch.Tensor, *, top_k: int, activation: str,
                       stats: list | None = None) -> torch.Tensor:
    """x: (B, T, d) -> y (B, T, d), every assignment computed: the router
    (span ``moe.route``), K12, the grouped expert products (``ffn.mlp``,
    the span of a dense layer's MLP) and K13."""
    B, T, d = x.shape
    E = p["router"].shape[-1]
    xf = x.reshape(B * T, d)
    with spans.span("moe.route", device=True):
        _, top_w, top_e = route(p, xf, top_k)
    xs, pos, rows, ends = kmoe.moe_dispatch(xf, top_e, E)
    with spans.span("ffn.mlp", device=True):
        out = expert_ffn_grouped(p, xs, ends, activation)
    y = kmoe.moe_combine(out, pos, top_w)
    if stats is not None:
        stats.append({"experts": top_e, "rows": rows})
    return y.reshape(B, T, d)
