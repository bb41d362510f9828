"""xLSTM blocks [arXiv:2405.04517]: sLSTM (post-up-projection) and mLSTM
(pre-up-projection), with their decode states.

Port of ``repro/models/layers/xlstm.py``.  Both use exponential gating
with the max-stabiliser state ``m``; sLSTM keeps a scalar memory per unit
with per-head recurrent gate projections, mLSTM a matrix memory C (hd ×
hd) per head updated by a gated outer product.  The reference scans over
time with ``lax.scan`` and wrote no Pallas kernel for it, so the scans are
Python loops here (:func:`~.scan_utils.chunked_scan`), every step plain
PyTorch; decode is one step of the same recurrence.

The sLSTM step takes the input's four gate projections for the whole
sequence before the loop (one product over the four gates' weights; each
output element is the reference's per-step einsum) and the recurrent four
in one batched product a step.  Gate pre-activations are summed in the
params' dtype and then cast to float32, as in the reference; mLSTM's
``wi``, ``bi``, ``wf`` and ``bf`` are float32.  sLSTM's GeGLU uses the
reference's ``jax.nn.gelu``, the tanh approximation.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import activation_fn, group_norm_heads, variance_scaling
from .mamba import causal_conv, conv_tail
from .scan_utils import chunked_scan

_GATES = ("z", "i", "f", "o")


# ================================================================= sLSTM
def init_slstm(generator: torch.Generator, d_model: int, n_heads: int,
               dtype: torch.dtype = torch.float32, *, lead: tuple = (),
               device: str | torch.device | None = None) -> dict:
    hd = d_model // n_heads
    dev = device or generator.device

    def w(shape, fan_in):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dtype,
                                device=dev)

    p = {}
    for g in _GATES:
        p[f"w{g}"] = w((d_model, n_heads, hd), d_model)
        p[f"r{g}"] = w((n_heads, hd, hd), hd)
        # Forget-gate bias 1 (retain memory early in training), others 0.
        p[f"b{g}"] = torch.full(lead + (n_heads, hd), float(g == "f"),
                                dtype=dtype, device=dev)
    # GeGLU FFN with the paper's 4/3 projection factor.
    pf = (4 * d_model) // 3
    p["up_g"] = w((d_model, pf), d_model)
    p["up_u"] = w((d_model, pf), d_model)
    p["down"] = w((pf, d_model), pf)
    return p


@dataclasses.dataclass
class SLSTMState:
    """sLSTM decode state, float32 (B, H, hd) each, or a stack of them with
    a leading layer axis."""
    h: torch.Tensor
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def init(batch: int, n_heads: int, hd: int, *, lead: tuple = (),
             device: str | torch.device = "cpu") -> "SLSTMState":
        def z():
            return torch.zeros(lead + (batch, n_heads, hd),
                               dtype=torch.float32, device=device)
        return SLSTMState(h=z(), c=z(), n=z(), m=z())


def _slstm_input_gates(p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> the input's gate projections (..., 4, H, hd), in
    :data:`_GATES` order."""
    w = torch.stack([p[f"w{g}"] for g in _GATES], dim=1)       # (d, 4, H, hd)
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _slstm_weights(p) -> tuple[torch.Tensor, torch.Tensor]:
    """The four gates' recurrent weights (4, H, hd, hd) and biases (4, H,
    hd), in :data:`_GATES` order."""
    return (torch.stack([p[f"r{g}"] for g in _GATES]),
            torch.stack([p[f"b{g}"] for g in _GATES]))


def _slstm_step(r: torch.Tensor, b: torch.Tensor, st: tuple,
                xg: torch.Tensor):
    """st = (h, c, n, m), float32 (B, H, hd); xg (B, 4, H, hd) the input's
    gate projections; r, b from :func:`_slstm_weights`.  Returns the new
    state and h."""
    h, c, n, m = st
    rec = torch.einsum("bhk,ghkj->bghj", h.to(xg.dtype), r)
    gz, gi, gf, go = ((xg + rec) + b).float().unbind(1)
    z, o = torch.tanh(gz), torch.sigmoid(go)
    m_new = torch.maximum(gf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gf + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n, min=1e-6)
    return (h, c, n, m_new), h


def _geglu(p, h: torch.Tensor) -> torch.Tensor:
    return (activation_fn("gelu")(h @ p["up_g"]) * (h @ p["up_u"])) @ p["down"]


def slstm_forward(p, x: torch.Tensor, *, return_state: bool = False):
    """x: (B, T, d) -> (B, T, d), the mixer output with its GeGLU FFN, and
    the final :class:`SLSTMState` with ``return_state``."""
    B, T, d = x.shape
    H, hd = p["wz"].shape[-2:]
    r, b = _slstm_weights(p)
    st0 = SLSTMState.init(B, H, hd, device=x.device)
    st, hs = chunked_scan(
        lambda s, inp: _slstm_step(r, b, s, inp[0]),
        (st0.h, st0.c, st0.n, st0.m),
        (_slstm_input_gates(p, x).transpose(0, 1),))
    h = group_norm_heads(hs.transpose(0, 1)).reshape(B, T, d).to(x.dtype)
    out = _geglu(p, h)
    return (out, SLSTMState(*st)) if return_state else out


def slstm_decode(p, x: torch.Tensor,
                 st: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    B = x.shape[0]
    new, h = _slstm_step(*_slstm_weights(p), (st.h, st.c, st.n, st.m),
                         _slstm_input_gates(p, x[:, 0]))
    h = group_norm_heads(h[:, None]).reshape(B, 1, -1).to(x.dtype)
    return _geglu(p, h), SLSTMState(*new)


# ================================================================= mLSTM
def init_mlstm(generator: torch.Generator, d_model: int, n_heads: int,
               dtype: torch.dtype = torch.float32, *, lead: tuple = (),
               device: str | torch.device | None = None) -> dict:
    di = 2 * d_model
    hd = di // n_heads
    dev = device or generator.device

    def w(shape, fan_in, dt=dtype):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dt,
                                device=dev)

    return {
        "up": w((d_model, 2 * di), d_model),
        "conv_w": w((4, di), 4),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "wq": w((di, n_heads, hd), di),
        "wk": w((di, n_heads, hd), di),
        "wv": w((di, n_heads, hd), di),
        "wi": w((di, n_heads), di, torch.float32),
        "bi": torch.zeros(lead + (n_heads,), dtype=torch.float32,
                          device=dev),
        "wf": w((di, n_heads), di, torch.float32),
        "bf": torch.full(lead + (n_heads,), 3.0, dtype=torch.float32,
                         device=dev),
        "down": w((di, d_model), di),
    }


@dataclasses.dataclass
class MLSTMState:
    """mLSTM decode state, or a stack of them with a leading layer axis."""
    conv: torch.Tensor  # (B, 3, di) rolling pre-conv inputs, params' dtype
    C: torch.Tensor     # (B, H, hd, hd) float32
    n: torch.Tensor     # (B, H, hd) float32
    m: torch.Tensor     # (B, H) float32

    @staticmethod
    def init(batch: int, n_heads: int, hd: int, di: int,
             dtype: torch.dtype = torch.float32, *, lead: tuple = (),
             device: str | torch.device = "cpu") -> "MLSTMState":
        f32 = dict(dtype=torch.float32, device=device)
        return MLSTMState(
            conv=torch.zeros(lead + (batch, 3, di), dtype=dtype,
                             device=device),
            C=torch.zeros(lead + (batch, n_heads, hd, hd), **f32),
            n=torch.zeros(lead + (batch, n_heads, hd), **f32),
            m=torch.zeros(lead + (batch, n_heads), **f32))


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...i,ihk->...hk"), in the promoted dtype as jnp.einsum
    takes mixed inputs (a decode from ``init_cache``'s float32 conv state
    in a bfloat16 model)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dt) @ w.to(dt).flatten(-2)).unflatten(-1, w.shape[-2:])


def _mlstm_qkvif(p, xc: torch.Tensor, xu: torch.Tensor):
    """xc: post-conv (..., di); xu: pre-conv (..., di)."""
    hd = p["wq"].shape[-1]
    q = _heads(xc, p["wq"])
    # The reference's weakly typed scale is rounded to k's dtype first.
    k = _heads(xc, p["wk"]) / torch.tensor(hd ** 0.5, dtype=xc.dtype)
    v = _heads(xu, p["wv"])
    it = xu.float() @ p["wi"] + p["bi"]
    ft = xu.float() @ p["wf"] + p["bf"]
    return q, k, v, it, ft


def _mlstm_step(st: tuple, q, k, v, it, ft):
    """st = (C, n, m); q, k, v: (B, H, hd); it, ft: (B, H)."""
    C, n, m = st
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)[..., None]                      # (B, H, 1)
    f = torch.exp(ft + m - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = f[..., None] * C + i[..., None] * vf[..., None] * kf[..., None, :]
    n = f * n + i * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)), min=1.0)
    return (C, n, m_new), num / den[..., None]


def mlstm_forward(p, x: torch.Tensor, *, return_state: bool = False):
    """x: (B, T, d) -> (B, T, d), and the final :class:`MLSTMState` with
    ``return_state``."""
    B, T, d = x.shape
    H, hd = p["wq"].shape[-2:]
    di = 2 * d
    xu, z = torch.chunk(x @ p["up"], 2, dim=-1)                # (B, T, di)
    xc = causal_conv(F.pad(xu, (0, 0, 3, 0)), p["conv_w"], p["conv_b"], T)
    st0 = MLSTMState.init(B, H, hd, di, x.dtype, device=x.device)
    (C, n, m), hs = chunked_scan(
        lambda s, inp: _mlstm_step(s, *inp), (st0.C, st0.n, st0.m),
        tuple(t.transpose(0, 1) for t in _mlstm_qkvif(p, xc, xu)))
    h = group_norm_heads(hs.transpose(0, 1)).reshape(B, T, di).to(x.dtype)
    out = (h * F.silu(z)) @ p["down"]
    if not return_state:
        return out
    return out, MLSTMState(conv=conv_tail(xu, 3), C=C, n=n, m=m)


def mlstm_decode(p, x: torch.Tensor,
                 st: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    B, _, d = x.shape
    di = 2 * d
    xu, z = torch.chunk((x @ p["up"])[:, 0], 2, dim=-1)       # (B, di)
    conv_in = torch.cat([st.conv, xu[:, None]], dim=1)
    xc = causal_conv(conv_in, p["conv_w"], p["conv_b"], 1)[:, 0]
    (C, n, m), h = _mlstm_step((st.C, st.n, st.m),
                               *_mlstm_qkvif(p, xc, xu))
    h = group_norm_heads(h[:, None]).reshape(B, 1, di).to(x.dtype)
    out = (h * F.silu(z)[:, None]) @ p["down"]
    return out, MLSTMState(conv=conv_in[:, 1:], C=C, n=n, m=m)
