"""The paper's own model: 4 hidden layers × 2000 ReLU units, softmax output.

TIMIT frame classifier (§3): 351-d cepstral input, 39 phone classes,
dropout 0.2 between hidden layers.

Parameters keep the reference layout — ``{"layers": [{"w": (in, out),
"b": (out,)}]}`` and ``x @ w + b`` — so a parameter set carries across the
two packages one to one (:mod:`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses

import torch

from .layers.common import variance_scaling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DNNConfig:
    input_dim: int = 351
    hidden_dim: int = 2000
    n_hidden: int = 4
    n_classes: int = 39
    dropout: float = 0.2


def init_dnn(cfg: DNNConfig, generator: torch.Generator | int = 0, *,
             device: torch.device | str | None = None) -> dict:
    """He-normal weights, zero biases.  An int seeds a CPU generator (the
    draw is then the same whatever ``device`` the params land on)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    device = generator.device if device is None else torch.device(device)
    dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.n_hidden + [cfg.n_classes]
    return {
        "layers": [
            {
                "w": variance_scaling(generator, (dims[i], dims[i + 1]),
                                      dims[i], scale=2.0).to(device),
                "b": torch.zeros(dims[i + 1], dtype=torch.float32,
                                 device=device),
            }
            for i in range(len(dims) - 1)
        ]
    }


def dnn_forward(params: dict, x: Tensor, *,
                generator: torch.Generator | None = None,
                dropout: float = 0.0,
                workers: tuple[int, int] | None = None) -> Tensor:
    """x: (..., input_dim) -> logits (..., n_classes).  Dropout runs only
    with a ``generator`` (on ``x``'s device) and ``dropout > 0``.

    ``workers = (first, k)`` says that ``x``'s leading axis holds workers
    ``first, first + 1, ...`` of a k-worker batch: each mask is drawn for
    the whole ``(k, ...)`` activation and sliced, so a rank that holds a
    share of the workers drops what the whole batch's step would."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
            if generator is not None and dropout > 0.0:
                shape = (h.shape if workers is None
                         else (workers[1],) + h.shape[1:])
                keep = torch.rand(shape, generator=generator,
                                  device=h.device) < 1.0 - dropout
                if workers is not None:
                    keep = keep[workers[0]: workers[0] + h.shape[0]]
                h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h


def dnn_hidden(params: dict, x: Tensor, *, layer: int = -1) -> Tensor:
    """Clean forward to hidden layer ``layer``'s post-ReLU activation
    (negative counts from the last hidden layer; never the logits)."""
    n_hidden = len(params["layers"]) - 1
    if not -n_hidden <= layer < n_hidden:
        raise ValueError(
            f"layer {layer} out of range for {n_hidden} hidden layers")
    stop = layer % n_hidden
    h = x
    for i, lyr in enumerate(params["layers"][:-1]):
        h = torch.relu(h @ lyr["w"] + lyr["b"])
        if i == stop:
            return h
    return h
