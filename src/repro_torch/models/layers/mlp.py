"""Dense feed-forward blocks: SwiGLU (llama-family) and GeLU/ReLU MLPs.

Port of ``repro/models/layers/mlp.py``; weights (d_model, d_ff) and
(d_ff, d_model) in the reference's layout, products through cuBLAS.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import activation_fn, variance_scaling


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, dtype: torch.dtype = torch.float32, *,
             lead: tuple = (),
             device: str | torch.device | None = None) -> dict:
    """``lead`` prepends stacking axes (one draw per stacked layer);
    ``device`` defaults to the generator's."""
    def w(shape, fan_in):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dtype,
                                device=device)

    if activation == "swiglu":
        return {"wg": w((d_model, d_ff), d_model),
                "wu": w((d_model, d_ff), d_model),
                "wd": w((d_ff, d_model), d_ff)}
    return {"wu": w((d_model, d_ff), d_model),
            "wd": w((d_ff, d_model), d_ff)}


def apply_mlp(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return activation_fn(activation)(x @ p["wu"]) @ p["wd"]
