"""Mamba (S6) selective-state-space mixer: full-sequence scan and decode.

Port of ``repro/models/layers/mamba.py``.  The reference keeps the
recurrence as a ``lax.scan`` over time with an O(B·d_inner·d_state) carry
and wrote no Pallas kernel for it, so the scan is a Python loop over T here
(:func:`~.scan_utils.chunked_scan`, chunks of 128 steps checkpointed under
autograd), every step plain PyTorch.  Decode is one step of the same
recurrence against a :class:`MambaState`.

Dtypes follow the reference: ``A_log`` and ``D`` are float32, the state
``ssm`` float32; ``dB = dt·Bm`` is a product in the params' dtype,
rounded to it, before it meets the float32 state.  The depthwise causal
conv sums its ``d_conv`` taps in float32 and rounds once to the input's
dtype, as the reference's einsum does (no cuDNN, whose float32 conv runs
in TF32).  ``softplus`` is ``F.softplus``, whose threshold (x > 20 gives
x) differs from ``jax.nn.softplus`` by less than float32's resolution.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .common import variance_scaling
from .scan_utils import chunked_scan


def init_mamba(generator: torch.Generator, d_model: int, *, expand: int,
               d_state: int, d_conv: int, dtype: torch.dtype = torch.float32,
               lead: tuple = (),
               device: str | torch.device | None = None) -> dict:
    """The reference's leaves and init; ``lead`` prepends stacking axes."""
    di = expand * d_model
    dtr = max(d_model // 16, 1)
    dev = device or generator.device

    def w(shape, fan_in):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dtype,
                                device=dev)

    u = torch.rand(lead + (di,), generator=generator, device=dev)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": w((d_model, 2 * di), d_model),
        "conv_w": w((d_conv, di), d_conv),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": w((di, dtr + 2 * d_state), di),
        "dt_proj_w": w((dtr, di), dtr),
        # softplus^-1 of dt drawn log-uniformly in [1e-3, 1e-1]
        "dt_proj_b": torch.log(torch.expm1(dt)).to(dtype),
        "A_log": torch.log(a).expand(lead + (di, d_state)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": w((di, d_model), di),
    }


@dataclasses.dataclass
class MambaState:
    """Decode state of one Mamba layer, or of a stack of layers with a
    leading layer axis."""
    conv: torch.Tensor   # (B, d_conv-1, di) rolling pre-conv inputs
    ssm: torch.Tensor    # (B, di, d_state) float32

    @staticmethod
    def init(batch: int, di: int, d_state: int, d_conv: int, dtype, *,
             lead: tuple = (),
             device: str | torch.device = "cpu") -> "MambaState":
        return MambaState(
            conv=torch.zeros(lead + (batch, d_conv - 1, di), dtype=dtype,
                             device=device),
            ssm=torch.zeros(lead + (batch, di, d_state), dtype=torch.float32,
                            device=device))


def causal_conv(xpad: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                T: int) -> torch.Tensor:
    """silu of the depthwise causal conv: xpad (B, T + K − 1, di) holds the
    K − 1 earlier inputs before the T new ones, w (K, di), b (di,).  The
    taps are summed in float32 and rounded once to xpad's dtype."""
    acc = sum(xpad[:, i:i + T].float() * w[i].float()
              for i in range(w.shape[0]))
    return F.silu(acc.to(xpad.dtype) + b)


def conv_tail(xi: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` pre-conv inputs of xi (B, T, di), left-padded with
    zeros when T < n."""
    T = xi.shape[1]
    return xi[:, T - n:] if T >= n else F.pad(xi, (0, 0, n - T, 0))


def _ssm_params(p, xc: torch.Tensor):
    """xc: (..., di) post-conv activations -> (dt, B, C) selective params."""
    d_state = p["A_log"].shape[-1]
    dtr = p["dt_proj_w"].shape[0]
    dt, Bm, Cm = torch.split(xc @ p["x_proj"], [dtr, d_state, d_state],
                             dim=-1)
    dt = F.softplus(dt @ p["dt_proj_w"] + p["dt_proj_b"])      # (..., di)
    return dt, Bm, Cm


def _ssm_step(p, A: torch.Tensor, h: torch.Tensor, xc, dt, Bm, Cm):
    """One recurrence step. A = −exp(A_log) (di, S); h: (B, di, S) float32;
    xc, dt: (B, di); Bm, Cm: (B, S)."""
    dA = torch.exp(dt[..., None].float() * A)                  # (B, di, S)
    dB = dt[..., None] * Bm[:, None, :]                         # params' dtype
    h = dA * h + dB.float() * xc[..., None].float()
    y = torch.einsum("bis,bs->bi", h, Cm.float()) + p["D"] * xc.float()
    return h, y.to(xc.dtype)


def mamba_forward(p, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence mixer. x: (B, T, d_model) -> (B, T, d_model), and the
    final :class:`MambaState` with ``return_state`` (the prefill)."""
    B, T, _ = x.shape
    d_conv, di = p["conv_w"].shape
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)            # (B, T, di)
    xc = causal_conv(F.pad(xi, (0, 0, d_conv - 1, 0)), p["conv_w"],
                     p["conv_b"], T)
    dt, Bm, Cm = _ssm_params(p, xc)                             # (B, T, ·)
    A = -torch.exp(p["A_log"])

    def step(h, inp):
        return _ssm_step(p, A, h, *inp)

    h0 = torch.zeros((B, di, p["A_log"].shape[-1]), dtype=torch.float32,
                     device=x.device)
    h_last, ys = chunked_scan(step, h0, tuple(
        t.transpose(0, 1) for t in (xc, dt, Bm, Cm)))
    y = ys.transpose(0, 1) * F.silu(z)                          # (B, T, di)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    return out, MambaState(conv=conv_tail(xi, d_conv - 1), ssm=h_last)


def mamba_decode(p, x: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, 1, d_model) -> ((B, 1, d_model), the new
    state)."""
    xi, z = torch.chunk((x @ p["in_proj"])[:, 0], 2, dim=-1)   # (B, di)
    conv_in = torch.cat([state.conv, xi[:, None]], dim=1)      # (B, K, di)
    xc = causal_conv(conv_in, p["conv_w"], p["conv_b"], 1)[:, 0]
    dt, Bm, Cm = _ssm_params(p, xc)
    h, y = _ssm_step(p, -torch.exp(p["A_log"]), state.ssm, xc, dt, Bm, Cm)
    out = ((y * F.silu(z)) @ p["out_proj"])[:, None]
    return out, MambaState(conv=conv_in[:, 1:], ssm=h)
