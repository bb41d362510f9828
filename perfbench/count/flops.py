"""Operations and bytes of the work a cell asks for, from its shapes.

Model FLOPs count each multiply-add as two operations and nothing that is
recomputed: the forward pass of a dense GQA decoder is its projections,
its SwiGLU, its causal attention (4·hd per kept query-key pair and head:
QKᵀ and PV; a row sees itself and the rows before it) and its head over
the positions whose logits are asked for; training adds the backward
pass at twice the forward.  K11's bound is the larger of its operations
over the chip's bf16 peak and its bytes (q, k, v read once, the output
written once) over the chip's memory bandwidth.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().with_name("peaks.json")


def peaks(kind: str) -> dict | None:
    """The published peaks of the device named ``kind``, or None."""
    with open(PEAKS) as fh:
        return json.load(fh).get(kind)


def kept_pairs(T: int) -> int:
    """Causal (query, key) pairs of one sequence of T tokens."""
    return T * (T + 1) // 2


def layer_matmul_flops(c: dict) -> int:
    """FLOPs of one layer's projections and SwiGLU, per token."""
    d, H, KV, hd, ff = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                        c["head_dim"], c["d_ff"])
    return 2 * (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff)


def attention_flops(c: dict, batch: int, T: int) -> int:
    """Causal attention of every layer over ``batch`` sequences of T."""
    return (4 * c["head_dim"] * c["n_heads"] * kept_pairs(T) * batch
            * c["n_layers"])


def forward_flops(c: dict, batch: int, T: int, head_positions: int) -> int:
    """The forward pass of ``batch`` sequences of T tokens, the head taken
    at ``head_positions`` positions."""
    return (batch * T * c["n_layers"] * layer_matmul_flops(c)
            + attention_flops(c, batch, T)
            + 2 * c["d_model"] * c["vocab_size"] * head_positions)


def train_step_flops(c: dict, batch: int, T: int) -> int:
    """Forward and backward of one LM training step: the head over every
    position (next-token CE) and over each sequence's pooled state (the
    SSL head)."""
    return 3 * forward_flops(c, batch, T, batch * T + batch)


def prefill_flops(c: dict, batch: int, T: int) -> int:
    """A prefill that returns every position's logits."""
    return forward_flops(c, batch, T, batch * T)


def k11_ops(c: dict, batch: int, T: int) -> int:
    """K11's operations in one layer: 4·hd a kept pair and query head."""
    return 4 * c["head_dim"] * c["n_heads"] * kept_pairs(T) * batch


def k11_bytes(c: dict, batch: int, T: int, itemsize: int = 2) -> int:
    """q and the output (H heads), k and v (KV heads), once each."""
    return (2 * c["n_heads"] + 2 * c["n_kv_heads"]) * c["head_dim"] \
        * batch * T * itemsize


def k11_bound_s(c: dict, batch: int, T: int, peak: dict) -> float:
    """The least time one K11 launch could take on a chip of ``peak``."""
    return max(k11_ops(c, batch, T) / peak["bf16_flops"],
               k11_bytes(c, batch, T) / peak["hbm_bytes_per_s"])
