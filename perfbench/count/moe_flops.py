"""Operations and bytes of a sparse MoE decoder's prefill (Mixtral's),
from its shapes.

Model FLOPs count each multiply-add as two operations: a token's
attention projections (QKV and out), its router (d·E), its ``top_k``
experts' SwiGLU FFNs (6·d·f each), causal attention (4·hd per kept query
and key pair and head, as ``flops.attention_flops``) and the head over
every position.  The bounds: the expert products (three grouped GEMMs a
layer) the larger of their operations over the bf16 peak and their
bytes (every expert's weights and the dispatched rows read once, the
output rows written once) over the memory's bandwidth; K12 (dispatch)
and K13 (combine) by bytes alone, each input read once and each output
written once.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_count_flops", Path(__file__).with_name("flops.py"))
flops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(flops)

#: Bytes of an expert id (int64), a row index (int32), a weight (float32).
ID_BYTES, POS_BYTES, WEIGHT_BYTES = 8, 4, 4


def _item(c: dict) -> int:
    return 4 if c["dtype"] == "float32" else 2


def attn_proj_flops(c: dict) -> int:
    """A token's QKV and out projections in one layer."""
    d, H, KV, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    return 2 * (d * (H + 2 * KV) * hd + H * hd * d)


def expert_flops(c: dict) -> int:
    """A token's router and its ``top_k`` experts' FFNs in one layer."""
    d, f = c["d_model"], c["d_ff"]
    return 2 * d * c["n_experts"] + c["top_k"] * 6 * d * f


def prefill_flops(c: dict, batch: int, T: int) -> int:
    """A prefill of ``batch`` sequences of T tokens that returns every
    position's logits."""
    N = batch * T
    return (N * c["n_layers"] * (attn_proj_flops(c) + expert_flops(c))
            + flops.attention_flops(c, batch, T)
            + 2 * c["d_model"] * c["vocab_size"] * N)


def experts_bound_s(c: dict, N: int, peak: dict) -> float:
    """The least time one layer's expert products over N tokens could
    take."""
    d, f, E, k = c["d_model"], c["d_ff"], c["n_experts"], c["top_k"]
    ops = 6 * d * f * N * k
    bytes_ = (3 * E * d * f + 2 * N * k * d) * _item(c)
    return max(ops / peak["bf16_flops"], bytes_ / peak["hbm_bytes_per_s"])


def dispatch_bytes(c: dict, N: int) -> int:
    """K12 over N tokens: the ids and x read, the rows, the row indices
    and the counts written."""
    d, k, E = c["d_model"], c["top_k"], c["n_experts"]
    return (N * k * ID_BYTES + N * d * _item(c) + N * k * d * _item(c)
            + N * k * POS_BYTES + 2 * E * POS_BYTES)


def combine_bytes(c: dict, N: int) -> int:
    """K13 over N tokens: the rows, their indices and weights read, y
    written."""
    d, k = c["d_model"], c["top_k"]
    return (N * k * d * _item(c) + N * k * (POS_BYTES + WEIGHT_BYTES)
            + N * d * _item(c))


def permute_bound_s(c: dict, N: int, peak: dict) -> float:
    """The least time one layer's K12 and K13 over N tokens could take."""
    return ((dispatch_bytes(c, N) + combine_bytes(c, N))
            / peak["hbm_bytes_per_s"])
