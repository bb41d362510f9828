"""Shared layer primitives: norms, embeddings, RoPE, initializers.

Port of ``repro/models/layers/common.py``.  Norms and RoPE compute in
float32 and cast back to the input's dtype, as the reference does; random
draws take an explicit ``torch.Generator`` and land on its device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...kernels.norm import rms_norm_ref


def variance_scaling(generator: torch.Generator, shape, fan_in: int, *,
                     scale: float = 1.0, dtype: torch.dtype = torch.float32,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """Normal init with std sqrt(scale / fan_in), drawn in ``dtype`` from
    ``generator`` on ``device`` (default: the generator's; ``"meta"``
    gives the shape and dtype and allocates nothing)."""
    std = (scale / max(fan_in, 1)) ** 0.5
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device or generator.device) * std


# ---------------------------------------------------------------- norms
def init_norm(d: int, kind: str = "rmsnorm", *, lead: tuple = (),
              device: str | torch.device = "cpu") -> dict:
    """Norm params, float32; ``lead`` prepends stacking axes."""
    p = {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """The norm as float32 torch ops (RMSNorm: K14's plain version), cast
    back to x's dtype; differentiable."""
    if kind == "rmsnorm":
        return rms_norm_ref(x, p["scale"], eps)
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"] + p["bias"]).to(x.dtype)


def group_norm_heads(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm (the xLSTM blocks' output norm), over the last
    axis of x (..., H, hd), in float32, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------- embed
def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.float32, *,
                   device: str | torch.device | None = None) -> dict:
    return {"table": torch.randn((vocab, d), generator=generator, dtype=dtype,
                                 device=device or generator.device) * 0.02}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


# ---------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float,
               device: str | torch.device = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding (split-half rotation). x: (B, T, H, hd); positions:
    (B, T) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].float() * freqs             # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str):
    """The reference's ``jax.nn`` activations; its ``gelu`` is the tanh
    approximation (``jax.nn.gelu``'s default)."""
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu,
            "silu": F.silu, "swish": F.silu}[name]
