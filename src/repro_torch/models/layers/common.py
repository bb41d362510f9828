"""Shared layer primitives."""
from __future__ import annotations

import torch


def variance_scaling(generator: torch.Generator, shape, fan_in: int, *,
                     scale: float = 1.0) -> torch.Tensor:
    """Normal init with std sqrt(scale / fan_in), drawn from ``generator``
    on its device."""
    std = (scale / max(fan_in, 1)) ** 0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * std
