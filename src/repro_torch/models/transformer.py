"""Decoder stack for dense attention models: init, forward, prefill, decode.

Port of ``repro/models/transformer.py``.  The stack is ``n_superblocks``
repetitions of ``cfg.block_pattern``; parameters of all super-blocks are
stacked on a leading axis, as in the reference, and the passes loop over
that axis in Python where the reference runs ``lax.scan``.  Everything but
the prefill's attention is plain PyTorch (cuBLAS products, as XLA's are in
the reference).

Entry points:
  * ``init_params``     — the reference's param tree, drawn from a
    ``torch.Generator`` on its device; ``abstract_params`` gives its shapes
    and dtypes on the ``meta`` device and allocates nothing;
  * ``forward``         — full-sequence training pass: hidden states,
    optional per-token logits and the mean-pooled SSL head; attention runs
    ``chunked_attention`` (which has a backward), and each super-block is
    rematerialised in the backward pass under ``cfg.remat_policy``;
  * ``prefill``         — full-sequence pass that returns the logits and
    fills the decode cache ``{"layers": [KVCache with a leading
    n_superblocks axis]}``, the structure of ``init_cache``; causal
    attention without a window runs on K11;
  * ``init_cache`` / ``decode_step`` — one-token autoregressive step; the
    cache is updated in place and returned.

Layer kinds ATTN and ATTN_SWA (sliding windows, ring caches of
``sliding_window`` slots) with dense FFNs are ported.  The other layer
kinds, MoE FFNs, ``first_layer_dense`` stacks and modality front ends wait
for later slices of the LM stack and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .config import ATTN, ATTN_SWA, ModelConfig
from .layers import attention as attn_lib
from .layers.attention import KVCache
from .layers.common import (apply_norm, embed, init_embedding, init_norm,
                            variance_scaling)
from .layers.mlp import apply_mlp, init_mlp

_SLICE = {
    "xattn": "with cross-attention and the modality front ends",
    "mamba": "with the Mamba layers",
    "slstm": "with the xLSTM layers",
    "mlstm": "with the xLSTM layers",
}


def _unported(what: str, when: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes {when} in a later slice of the "
        f"LM stack")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    for kind in cfg.block_pattern:
        if kind not in (ATTN, ATTN_SWA):
            raise _unported(f"{cfg.name}: layer kind {kind!r}",
                            _SLICE.get(kind, ""))
    if cfg.is_moe:
        raise _unported(f"{cfg.name}: MoE FFN", "with the MoE layers")
    if cfg.first_layer_dense:
        raise _unported(f"{cfg.name}: first_layer_dense",
                        "with the dense first block of MoE stacks")
    if cfg.modality_dim:
        raise _unported(f"{cfg.name}: modality front end",
                        "with cross-attention and the modality front ends")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.sliding_window if kind == ATTN_SWA else None


# ===================================================================== init
def _init_layer(generator: torch.Generator, cfg: ModelConfig, lead: tuple,
                device) -> dict:
    dt = _dtype(cfg)
    p: dict[str, Any] = {
        "norm1": init_norm(cfg.d_model, cfg.norm, lead=lead, device=device),
        "attn": attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead, device=device)}
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, lead=lead,
                               device=device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                            dt, lead=lead, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device | None = None) -> dict:
    """The reference's tree, shapes and dtypes; each stacked leaf is one
    draw of shape (n_superblocks, ...) from ``generator``, on ``device``
    (default: the generator's)."""
    check_supported(cfg)
    dt, dev = _dtype(cfg), device or generator.device
    params: dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dt,
                                device=dev),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = variance_scaling(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype=dt,
            device=dev)
    lead = (cfg.n_superblocks,)
    params["superblocks"] = [_init_layer(generator, cfg, lead, dev)
                             for _ in cfg.block_pattern]
    return params


def abstract_params(cfg: ModelConfig, *,
                    param_dtype: str | None = None) -> dict:
    """The param tree's shapes and dtypes as ``meta`` tensors (nothing is
    allocated), every leaf in ``param_dtype`` when it is given."""
    tree = init_params(cfg, torch.Generator(), device="meta")
    if param_dtype is None:
        return tree
    dt = getattr(torch, param_dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(dt)

    return cast(tree)


def _block(params: dict, i: int) -> list:
    """Super-block ``i``'s layer params, as views of the stacked leaves."""
    def pick(tree):
        if isinstance(tree, dict):
            return {key: pick(val) for key, val in tree.items()}
        return tree[i]
    return [pick(layer) for layer in params["superblocks"]]


def _apply_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "norm2" not in p:
        return torch.zeros_like(x)
    return apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm),
                     cfg.activation)


def output_head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(d_model, vocab) output projection (tied or separate)."""
    return (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])


# =================================================================== forward
def _superblock_fwd(block_params: list, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    for p, kind in zip(block_params, cfg.block_pattern):
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + attn_lib.attention_block(p["attn"], h, positions,
                                         theta=cfg.rope_theta,
                                         window=_window(cfg, kind))
        x = x + _apply_ffn(p, cfg, x)
    return x


#: Matmuls with no batch dimension (the projections and the MLP; the
#: attention tiles' einsums are batched): what ``remat_policy="dots"``
#: keeps, as ``dots_with_no_batch_dims_saveable`` does in the reference.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            with_logits: bool = True) -> dict:
    """Full-sequence forward -> {"logits": (B, T, V) or None, "hidden":
    (B, T, d), "pooled_logits": (B, V), "moe_aux": 0-d float32}.

    ``pooled_logits`` is the SSL head: the output distribution of the
    mean-pooled sequence representation.  Each super-block runs under
    non-reentrant ``torch.utils.checkpoint`` per ``cfg.remat_policy``:
    ``"full"`` keeps only its input, ``"dots"`` also its matmul outputs,
    ``"none"`` (no checkpoint) everything."""
    check_supported(cfg)
    B, T = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    for i in range(cfg.n_superblocks):
        block = _block(params, i)
        if cfg.remat_policy == "none":
            x = _superblock_fwd(block, cfg, x, positions)
            continue
        kwargs = {"use_reentrant": False}
        if cfg.remat_policy == "dots":
            kwargs["context_fn"] = lambda: (
                create_selective_checkpoint_contexts(_save_dots))
        x = checkpoint(_superblock_fwd, block, cfg, x, positions, **kwargs)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = output_head(params, cfg)
    return {"logits": x @ head if with_logits else None, "hidden": x,
            "pooled_logits": torch.mean(x, dim=1) @ head,
            "moe_aux": torch.zeros((), dtype=torch.float32,
                                   device=x.device)}


# =================================================================== prefill
def _pad_kv_cache(c: KVCache, cache_len: int) -> KVCache:
    T = c.k.shape[1]
    if T >= cache_len:
        return c
    pad = cache_len - T
    return KVCache(k=F.pad(c.k, (0, 0, 0, 0, 0, pad)),
                   v=F.pad(c.v, (0, 0, 0, 0, 0, pad)),
                   positions=F.pad(c.positions, (0, pad)),
                   valid=F.pad(c.valid, (0, pad)))


def _stack(caches: list[KVCache]) -> KVCache:
    return KVCache(*(torch.stack([getattr(c, f) for c in caches])
                     for f in ("k", "v", "positions", "valid")))


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int | None = None) -> tuple[dict, dict]:
    """Full-sequence pass that also fills the decode cache.

    tokens (B, T) -> ({"logits": (B, T, V)}, cache), full caches padded to
    ``cache_len`` slots, ring caches of ATTN_SWA layers ``sliding_window``
    slots, laid out as incremental ``decode_step`` updates would lay them
    out."""
    check_supported(cfg)
    B, T = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    per_position: list[list[KVCache]] = [[] for _ in cfg.block_pattern]
    for i in range(cfg.n_superblocks):
        for j, (p, kind) in enumerate(zip(_block(params, i),
                                          cfg.block_pattern)):
            h = apply_norm(p["norm1"], x, cfg.norm)
            y, c = attn_lib.attention_block(p["attn"], h, positions,
                                            theta=cfg.rope_theta,
                                            window=_window(cfg, kind),
                                            return_kv=True)
            if kind == ATTN and cache_len is not None:
                c = _pad_kv_cache(c, cache_len)
            x = x + y
            x = x + _apply_ffn(p, cfg, x)
            per_position[j].append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x @ output_head(params, cfg)
    return {"logits": logits}, {"layers": [_stack(c) for c in per_position]}


# ==================================================================== decode
def _cache_slots(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == ATTN_SWA:
        return min(cfg.sliding_window or cache_len, cache_len)
    return cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str | torch.device = "cpu") -> dict:
    """Decode cache: per pattern position, a :class:`KVCache` stacked over
    super-blocks (zeros, no slot valid); ``cache_len`` slots, or
    ``min(sliding_window, cache_len)`` for an ATTN_SWA layer's ring."""
    check_supported(cfg)
    return {"layers": [
        KVCache.init(batch, _cache_slots(cfg, kind, cache_len),
                     cfg.n_kv_heads, cfg.hd, _dtype(cfg),
                     lead=(cfg.n_superblocks,), device=device)
        for kind in cfg.block_pattern]}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One autoregressive step. tokens: (B, 1); pos: (B,). Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    x = embed(params["embed"], tokens)
    for i in range(cfg.n_superblocks):
        for p, kind, stacked in zip(_block(params, i), cfg.block_pattern,
                                    cache["layers"]):
            h = apply_norm(p["norm1"], x, cfg.norm)
            y, _ = attn_lib.attention_decode(p["attn"], h, pos,
                                             stacked.layer(i),
                                             theta=cfg.rope_theta,
                                             window=_window(cfg, kind))
            x = x + y
            x = x + _apply_ffn(p, cfg, x)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x @ output_head(params, cfg), cache
