"""Weights of a sparse MoE decoder (Mixtral's), made from the seed.

Both sides of the comparison get them from here: the program under test,
as the nest of ``repro_torch.models.transformer``'s params, and the
plain reference, by leaf name.  Each leaf is drawn on the device with one
``torch.Generator``, one layer of a stacked leaf at a time (a whole
stacked expert leaf holds more values than one draw may), in the
configuration's dtype, and the router and the norm scales in float32.
"""
from __future__ import annotations

import torch

from .inputs import EMBED_STD, NORM_JITTER

#: The groups of a layer's leaves in the program's nest.
LAYER_GROUPS = ("norm1", "attn", "norm2", "moe")


def leaf_specs(c: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every leaf of configuration ``c``;
    layer leaves are stacked over the layers on a leading axis; ``kind``
    is ``"w"`` (the configuration's dtype), ``"router"`` (float32) or
    ``"norm"`` (a float32 scale, 1 + NORM_JITTER·N(0, 1))."""
    L, d, H, KV = c["n_layers"], c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd, f, V, E = c["head_dim"], c["d_ff"], c["vocab_size"], c["n_experts"]
    return [("embed.table", (V, d), "w", EMBED_STD),
            ("final_norm.scale", (d,), "norm", 0.0),
            ("lm_head", (d, V), "w", d ** -0.5),
            ("norm1.scale", (L, d), "norm", 0.0),
            ("attn.wq", (L, d, H, hd), "w", d ** -0.5),
            ("attn.wk", (L, d, KV, hd), "w", d ** -0.5),
            ("attn.wv", (L, d, KV, hd), "w", d ** -0.5),
            ("attn.wo", (L, H, hd, d), "w", (H * hd) ** -0.5),
            ("norm2.scale", (L, d), "norm", 0.0),
            ("moe.router", (L, d, E), "router", d ** -0.5),
            ("moe.wg", (L, E, d, f), "w", d ** -0.5),
            ("moe.wu", (L, E, d, f), "w", d ** -0.5),
            ("moe.wd", (L, E, f, d), "w", f ** -0.5)]


def make_weights(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> leaf, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtypes = {"w": getattr(torch, c["dtype"]), "router": torch.float32,
              "norm": torch.float32}
    out = {}
    for name, shape, kind, std in leaf_specs(c):
        leaf = torch.empty(shape, dtype=dtypes[kind], device=device)
        stacked = name.partition(".")[0] in LAYER_GROUPS
        for part in (leaf.unbind(0) if stacked else (leaf,)):
            if kind == "norm":
                part.normal_(1.0, NORM_JITTER, generator=gen)
            else:
                part.normal_(0.0, std, generator=gen)
        out[name] = leaf
    return out


def program_tree(w: dict[str, torch.Tensor]) -> dict:
    """The leaves in the nest of the program's params (one pattern
    position, ATTN_SWA, with a MoE FFN)."""
    layer: dict = {}
    for name, leaf in w.items():
        group, _, key = name.partition(".")
        if group in LAYER_GROUPS:
            layer.setdefault(group, {})[key] = leaf
    return {"embed": {"table": w["embed.table"]},
            "final_norm": {"scale": w["final_norm.scale"]},
            "lm_head": w["lm_head"], "superblocks": [layer]}
