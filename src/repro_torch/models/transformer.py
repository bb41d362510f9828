"""Decoder stack for serving dense attention models: init, prefill, decode.

Port of the serving half of ``repro/models/transformer.py``.  The stack is
``n_superblocks`` repetitions of ``cfg.block_pattern``; parameters of all
super-blocks are stacked on a leading axis, as in the reference, and the
passes loop over that axis in Python where the reference runs
``lax.scan``.  Every causal self-attention of the prefill runs on K11
(:func:`repro_torch.kernels.ops.flash_attention_gqa`); everything else is
plain PyTorch (cuBLAS products, as XLA's are in the reference).

Entry points:
  * ``init_params`` — the reference's param tree, drawn from a
    ``torch.Generator`` on its device;
  * ``prefill``     — full-sequence pass that returns the logits and fills
    the decode cache ``{"layers": [KVCache with a leading n_superblocks
    axis]}``, the structure of ``init_cache``;
  * ``init_cache`` / ``decode_step`` — one-token autoregressive step; the
    cache is updated in place and returned.

Only ATTN layers with dense FFNs are ported.  The other layer kinds, MoE
FFNs, ``first_layer_dense``, modality front ends and ``forward`` (the
training/SSL head) wait for later slices of the LM stack and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .config import ATTN, ModelConfig
from .layers import attention as attn_lib
from .layers.attention import KVCache
from .layers.common import (apply_norm, embed, init_embedding, init_norm,
                            variance_scaling)
from .layers.mlp import apply_mlp, init_mlp

_SLICE = {
    "attn_swa": "with chunked_attention's window masks and ring caches",
    "xattn": "with cross-attention",
    "mamba": "with the Mamba layers",
    "slstm": "with the xLSTM layers",
    "mlstm": "with the xLSTM layers",
}


def _unported(what: str, when: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes {when} in a later slice of the "
        f"LM stack")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not serve."""
    for kind in cfg.block_pattern:
        if kind != ATTN:
            raise _unported(f"{cfg.name}: layer kind {kind!r}",
                            _SLICE.get(kind, ""))
    if cfg.is_moe:
        raise _unported(f"{cfg.name}: MoE FFN", "with the MoE layers")
    if cfg.first_layer_dense:
        raise _unported(f"{cfg.name}: first_layer_dense",
                        "with the training slice")
    if cfg.modality_dim:
        raise _unported(f"{cfg.name}: modality front end",
                        "with cross-attention")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===================================================================== init
def _init_layer(generator: torch.Generator, cfg: ModelConfig,
                lead: tuple) -> dict:
    dt, dev = _dtype(cfg), generator.device
    p: dict[str, Any] = {
        "norm1": init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev),
        "attn": attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead)}
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, lead=lead, device=dev)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                            dt, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's tree, shapes and dtypes; each stacked leaf is one
    draw of shape (n_superblocks, ...) from ``generator``, on its device."""
    check_supported(cfg)
    dt = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": init_norm(cfg.d_model, cfg.norm,
                                device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = variance_scaling(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype=dt)
    lead = (cfg.n_superblocks,)
    params["superblocks"] = [_init_layer(generator, cfg, lead)
                             for _ in cfg.block_pattern]
    return params


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

    tokens (B, T) -> ({"logits": (B, T, V)}, cache), the cache padded to
    ``cache_len`` slots and laid out as incremental ``decode_step`` updates
    would lay it out."""
    check_supported(cfg)
    B, T = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    per_position: list[list[KVCache]] = [[] for _ in cfg.block_pattern]
    for i in range(cfg.n_superblocks):
        for j, p in enumerate(_block(params, i)):
            h = apply_norm(p["norm1"], x, cfg.norm)
            y, c = attn_lib.attention_block(p["attn"], h, positions,
                                            theta=cfg.rope_theta,
                                            return_kv=True)
            if cache_len is not None:
                c = _pad_kv_cache(c, cache_len)
            x = x + y
            x = x + _apply_ffn(p, cfg, x)
            per_position[j].append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x @ output_head(params, cfg)
    return {"logits": logits}, {"layers": [_stack(c) for c in per_position]}


# ==================================================================== decode
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str | torch.device = "cpu") -> dict:
    """Decode cache: per pattern position, a :class:`KVCache` stacked over
    super-blocks (zeros, no slot valid)."""
    check_supported(cfg)
    return {"layers": [
        KVCache.init(batch, cache_len, cfg.n_kv_heads, cfg.hd, _dtype(cfg),
                     lead=(cfg.n_superblocks,), device=device)
        for _ in cfg.block_pattern]}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One autoregressive step. tokens: (B, 1); pos: (B,). Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    x = embed(params["embed"], tokens)
    for i in range(cfg.n_superblocks):
        for p, stacked in zip(_block(params, i), cache["layers"]):
            h = apply_norm(p["norm1"], x, cfg.norm)
            y, _ = attn_lib.attention_decode(p["attn"], h, pos,
                                             stacked.layer(i),
                                             theta=cfg.rope_theta)
            x = x + y
            x = x + _apply_ffn(p, cfg, x)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x @ output_head(params, cfg), cache
