"""Decoder stack for every architecture family: init, forward, prefill,
decode.

Port of ``repro/models/transformer.py``.  The stack is ``n_superblocks``
repetitions of ``cfg.block_pattern``; parameters of all super-blocks are
stacked on a leading axis, as in the reference, and the passes loop over
that axis in Python where the reference runs ``lax.scan``.  A
``first_layer_dense`` stack (kimi) runs an unstacked dense first block
(``params["first_block"]``, ``cache["first"]``) before the scanned ones.
Everything but the prefill's causal self-attention is plain PyTorch
(cuBLAS products, as XLA's are in the reference).

Layer kinds (``_apply_mixer``, ``_layer_cache``, ``_decode_layer``):
ATTN and ATTN_SWA (sliding windows, ring caches of ``sliding_window``
slots), XATTN (cross-attention to the projected modality embeddings,
``params["modality_proj"]``; its cache holds the memory's k and v),
MAMBA (:class:`~.layers.mamba.MambaState`), SLSTM and MLSTM (xLSTM blocks
with their own projections and no FFN).  The FFN after a mixer is dense
or MoE (``cfg.moe_layer``), and ``forward`` sums the MoE layers'
load-balance losses into ``moe_aux``.

Entry points:
  * ``init_params``     — the reference's param tree, drawn from a
    ``torch.Generator`` on its device; ``abstract_params`` gives its shapes
    and dtypes on the ``meta`` device and allocates nothing;
  * ``forward``         — full-sequence training pass: hidden states,
    optional per-token logits, the mean-pooled SSL head and ``moe_aux``;
    attention runs ``chunked_attention`` (which has a backward), and each
    scanned super-block is rematerialised in the backward pass under
    ``cfg.remat_policy``;
  * ``prefill``         — full-sequence pass that returns the logits and
    fills the decode cache ``{"layers": [one cache per pattern position,
    stacked over the scanned super-blocks]}`` (and ``"first"``), the
    structure of ``init_cache``; causal self-attention runs on K11 where
    no window or a window that covers the prompt masks it;
  * ``init_cache`` / ``decode_step`` — one-token autoregressive step; the
    caches and states are updated in place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import spans
from ..kernels import norm as norm_kernels
from .config import ATTN, ATTN_SWA, MAMBA, MLSTM, SLSTM, XATTN, ModelConfig
from .layers import attention as attn_lib
from .layers import mamba as mamba_lib
from .layers import moe as moe_lib
from .layers import xlstm as xlstm_lib
from .layers.attention import KVCache
from .layers.common import (apply_norm, embed, init_embedding, init_norm,
                            variance_scaling)
from .layers.mamba import MambaState
from .layers.mlp import apply_mlp, init_mlp
from .layers.xlstm import MLSTMState, SLSTMState

#: Layer kinds a block pattern may hold.
KINDS = (ATTN, ATTN_SWA, XATTN, MAMBA, SLSTM, MLSTM)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the stack does not know."""
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.sliding_window if kind == ATTN_SWA else None


def _n_scan(cfg: ModelConfig) -> int:
    """Scanned super-blocks: all of them, less the dense first block."""
    return cfg.n_superblocks - (1 if cfg.first_layer_dense else 0)


# ===================================================================== init
def _init_layer(generator: torch.Generator, cfg: ModelConfig, kind: str,
                pattern_pos: int, lead: tuple, device, *,
                force_dense_ffn: bool = False) -> dict:
    dt = _dtype(cfg)
    kw = dict(lead=lead, device=device)
    p: dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm, **kw)}
    if kind in (ATTN, ATTN_SWA):
        p["attn"] = attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            qkv_bias=cfg.qkv_bias, dtype=dt, **kw)
    elif kind == XATTN:
        p["attn"] = attn_lib.init_cross_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            dtype=dt, **kw)
    elif kind == MAMBA:
        p["mamba"] = mamba_lib.init_mamba(
            generator, cfg.d_model, expand=cfg.mamba_expand,
            d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv, dtype=dt,
            **kw)
    elif kind == SLSTM:
        p["block"] = xlstm_lib.init_slstm(generator, cfg.d_model,
                                          cfg.n_heads, dt, **kw)
        return p
    elif kind == MLSTM:
        p["block"] = xlstm_lib.init_mlstm(generator, cfg.d_model,
                                          cfg.n_heads, dt, **kw)
        return p
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, **kw)
        if cfg.moe_layer(pattern_pos) and not force_dense_ffn:
            p["moe"] = moe_lib.init_moe(
                generator, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                cfg.n_experts, cfg.activation, dt, **kw)
        else:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.activation, dt, **kw)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device | None = None) -> dict:
    """The reference's tree, shapes and dtypes; each stacked leaf is one
    draw of shape (scanned super-blocks, ...) from ``generator``, on
    ``device`` (default: the generator's)."""
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
    if cfg.modality_dim:
        params["modality_proj"] = variance_scaling(
            generator, (cfg.modality_dim, cfg.d_model), cfg.modality_dim,
            dtype=dt, device=dev)
    if cfg.first_layer_dense:
        params["first_block"] = [_init_layer(
            generator, cfg, cfg.block_pattern[0], 0, (), dev,
            force_dense_ffn=True)]
    lead = (_n_scan(cfg),)
    params["superblocks"] = [_init_layer(generator, cfg, kind, i, lead, dev)
                             for i, kind in enumerate(cfg.block_pattern)]
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
    """Scanned super-block ``i``'s layer params, as views of the stacked
    leaves."""
    def pick(tree):
        if isinstance(tree, dict):
            return {key: pick(val) for key, val in tree.items()}
        return tree[i]
    return [pick(layer) for layer in params["superblocks"]]


def output_head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(d_model, vocab) output projection (tied or separate)."""
    return (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])


def _memory(params: dict, modality_embeds: torch.Tensor | None,
            dtype: torch.dtype) -> torch.Tensor | None:
    """modality_embeds (B, M, modality_dim) @ modality_proj, in the
    promoted dtype (as jnp.einsum), cast to the activations' ``dtype``."""
    if modality_embeds is None:
        return None
    proj = params["modality_proj"]
    dt = torch.promote_types(modality_embeds.dtype, proj.dtype)
    return (modality_embeds.to(dt) @ proj.to(dt)).to(dtype)


# =================================================================== forward
def _prefill_norm(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """A norm of the prefill: RMSNorm in one launch of K14
    (``kernels.norm.rms_norm``; on the CPU its plain version, the
    composite), LayerNorm as :func:`apply_norm`.  Forward only: training's
    ``forward`` and ``decode_step`` keep :func:`apply_norm`."""
    if kind == "rmsnorm":
        return norm_kernels.rms_norm(x, p["scale"])
    return apply_norm(p, x, kind)


def _apply_mixer(p, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 positions: torch.Tensor, mem: torch.Tensor | None, *,
                 return_state: bool = False):
    """The mixer of one layer on norm1(x); with ``return_state`` (the
    prefill) also its decode cache or state, and norm1 by
    :func:`_prefill_norm`."""
    norm = _prefill_norm if return_state else apply_norm
    with spans.span("attn.norm", device=True):
        h = norm(p["norm1"], x, cfg.norm)
    if kind in (ATTN, ATTN_SWA):
        return attn_lib.attention_block(p["attn"], h, positions,
                                        theta=cfg.rope_theta,
                                        window=_window(cfg, kind),
                                        return_kv=return_state)
    if kind == XATTN:
        mk, mv = attn_lib.cross_kv(p["attn"], mem)
        y = attn_lib.cross_attention_block(p["attn"], h, mk, mv)
        if not return_state:
            return y
        B, M = mk.shape[:2]
        pos = torch.arange(M, dtype=torch.int32, device=x.device)
        return y, KVCache(k=mk, v=mv, positions=pos[None].expand(B, M),
                          valid=torch.ones((B, M), dtype=torch.bool,
                                           device=x.device))
    if kind == MAMBA:
        return mamba_lib.mamba_forward(p["mamba"], h,
                                       return_state=return_state)
    if kind == SLSTM:
        return xlstm_lib.slstm_forward(p["block"], h,
                                       return_state=return_state)
    if kind == MLSTM:
        return xlstm_lib.mlstm_forward(p["block"], h,
                                       return_state=return_state)
    raise ValueError(kind)


def _apply_ffn(p, cfg: ModelConfig, x: torch.Tensor, *,
               moe_dispatch: str = "capacity", moe_stats: list | None = None,
               norm=apply_norm) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Post-mixer FFN (dense or MoE) of a layer that has one -> (out, the
    MoE load-balance loss or None), norm2 by ``norm`` (the prefill's
    :func:`_prefill_norm`).  A MoE layer dispatches as ``moe_dispatch``
    says (:data:`~.layers.moe.DISPATCH`; the dropless layer computes no
    loss) and appends its record to ``moe_stats``."""
    with spans.span("ffn.norm", device=True):
        h = norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        with spans.span("ffn.moe", device=True):
            if moe_dispatch == "dropless":
                return moe_lib.apply_moe_dropless(
                    p["moe"], h, top_k=cfg.top_k, activation=cfg.activation,
                    stats=moe_stats), None
            return moe_lib.apply_moe(p["moe"], h, top_k=cfg.top_k,
                                     capacity_factor=cfg.capacity_factor,
                                     activation=cfg.activation,
                                     dispatch_groups=cfg.moe_dispatch_groups,
                                     stats=moe_stats)
    with spans.span("ffn.mlp", device=True):
        return apply_mlp(p["mlp"], h, cfg.activation), None


def _check_dispatch(moe_dispatch: str) -> None:
    if moe_dispatch not in moe_lib.DISPATCH:
        raise ValueError(f"moe_dispatch must be one of {moe_lib.DISPATCH}, "
                         f"got {moe_dispatch!r}")


def _superblock_fwd(block_params: list, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, mem: torch.Tensor | None):
    """-> (x, the block's summed MoE loss, 0-d float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(block_params, cfg.block_pattern):
        x = x + _apply_mixer(p, cfg, kind, x, positions, mem)
        if "norm2" in p:
            y, a = _apply_ffn(p, cfg, x)
            x = x + y
            if a is not None:
                aux = aux + a
    return x, aux


#: Matmuls with no batch dimension (the projections and the MLP; the
#: attention tiles' einsums and the expert products are batched): what
#: ``remat_policy="dots"`` keeps, as ``dots_with_no_batch_dims_saveable``
#: does in the reference.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            modality_embeds: torch.Tensor | None = None,
            with_logits: bool = True) -> dict:
    """Full-sequence forward -> {"logits": (B, T, V) or None, "hidden":
    (B, T, d), "pooled_logits": (B, V), "moe_aux": 0-d float32}.

    ``pooled_logits`` is the SSL head: the output distribution of the
    mean-pooled sequence representation.  ``modality_embeds`` (B, M,
    modality_dim) feed the XATTN layers.  Each scanned super-block runs
    under non-reentrant ``torch.utils.checkpoint`` per
    ``cfg.remat_policy``: ``"full"`` keeps only its input, ``"dots"`` also
    its matmul outputs, ``"none"`` (no checkpoint) everything; the dense
    first block is not checkpointed, as in the reference."""
    check_supported(cfg)
    B, T = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    mem = _memory(params, modality_embeds, x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.first_layer_dense:
        x, a = _superblock_fwd(params["first_block"], cfg, x, positions, mem)
        aux = aux + a
    for i in range(_n_scan(cfg)):
        block = _block(params, i)
        if cfg.remat_policy == "none":
            x, a = _superblock_fwd(block, cfg, x, positions, mem)
        else:
            kwargs = {"use_reentrant": False}
            if cfg.remat_policy == "dots":
                kwargs["context_fn"] = lambda: (
                    create_selective_checkpoint_contexts(_save_dots))
            x, a = checkpoint(_superblock_fwd, block, cfg, x, positions, mem,
                              **kwargs)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = output_head(params, cfg)
    return {"logits": x @ head if with_logits else None, "hidden": x,
            "pooled_logits": torch.mean(x, dim=1) @ head, "moe_aux": aux}


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


def _fields(state) -> list[str]:
    return [f.name for f in dataclasses.fields(state)]


def _stack(states: list):
    """Caches or states of one pattern position, stacked on a new leading
    axis."""
    return type(states[0])(**{f: torch.stack([getattr(s, f) for s in states])
                              for f in _fields(states[0])})


def _superblock_prefill(block_params: list, cfg: ModelConfig,
                        x: torch.Tensor, positions: torch.Tensor,
                        mem: torch.Tensor | None, cache_len: int | None,
                        layer0: int, ffn_kw: dict):
    """-> (x, the block's caches); its first layer is decoder layer
    ``layer0`` (the ``i`` of its ``layer`` span); ``ffn_kw`` goes to
    :func:`_apply_ffn`."""
    caches = []
    for j, (p, kind) in enumerate(zip(block_params, cfg.block_pattern)):
        with spans.span("layer", i=layer0 + j):
            with spans.span("attn"):
                y, c = _apply_mixer(p, cfg, kind, x, positions, mem,
                                    return_state=True)
                if kind == ATTN and cache_len is not None:
                    with spans.span("attn.cache"):
                        c = _pad_kv_cache(c, cache_len)
                x = x + y
            if "norm2" in p:
                with spans.span("ffn"):
                    x = x + _apply_ffn(p, cfg, x, **ffn_kw)[0]
        caches.append(c)
    return x, caches


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            modality_embeds: torch.Tensor | None = None,
            cache_len: int | None = None,
            moe_dispatch: str = "capacity") -> tuple[dict, dict]:
    """Full-sequence pass that also fills the decode cache.

    tokens (B, T) -> ({"logits": (B, T, V)}, cache): full KV caches padded
    to ``cache_len`` slots, ring caches of ATTN_SWA layers
    ``sliding_window`` slots laid out as incremental ``decode_step``
    updates would lay them out, XATTN layers the memory's k and v, Mamba
    and xLSTM layers their states after the last token.  MoE layers
    dispatch as ``moe_dispatch`` says (the reference's capacity by
    default; the serving entry points ask for ``"dropless"``), and the
    output's ``"moe"`` holds their records (``layers.moe``'s ``stats``),
    in layer order.  Its RMSNorms (norm1, norm2, the final norm) run K14,
    one launch each on the card (:func:`_prefill_norm`).

    The pass is a request of :mod:`repro_torch.spans` (``prefill``, with
    a device interval): ``prefill.embed``, a ``layer`` span a decoder
    layer (``attn``, ``ffn`` and their parts), ``prefill.cache_stack``
    and ``prefill.head``."""
    check_supported(cfg)
    _check_dispatch(moe_dispatch)
    B, T = tokens.shape
    n = len(cfg.block_pattern)
    moe_stats: list = []
    ffn_kw = {"moe_dispatch": moe_dispatch, "moe_stats": moe_stats,
              "norm": _prefill_norm}
    with spans.request("prefill", device=tokens.device, batch=B, tokens=T):
        with spans.span("prefill.embed"):
            x = embed(params["embed"], tokens)
            positions = torch.arange(T, device=tokens.device)[None].expand(
                B, T)
            mem = _memory(params, modality_embeds, x.dtype)
        cache: dict[str, Any] = {}
        layer0 = 0
        if cfg.first_layer_dense:
            x, cache["first"] = _superblock_prefill(
                params["first_block"], cfg, x, positions, mem, cache_len, 0,
                ffn_kw)
            layer0 = n
        per_position: list[list] = [[] for _ in cfg.block_pattern]
        for i in range(_n_scan(cfg)):
            x, caches = _superblock_prefill(_block(params, i), cfg, x,
                                            positions, mem, cache_len,
                                            layer0 + i * n, ffn_kw)
            for j, c in enumerate(caches):
                per_position[j].append(c)
        with spans.span("prefill.cache_stack"):
            cache["layers"] = [_stack(c) for c in per_position]
        with spans.span("prefill.head"):
            with spans.span("head.norm", device=True):
                x = _prefill_norm(params["final_norm"], x, cfg.norm)
            out = {"logits": x @ output_head(params, cfg)}
    if cfg.is_moe:
        out["moe"] = moe_stats
    return out, cache


# ==================================================================== decode
def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 lead: tuple, device):
    dt, kw = _dtype(cfg), dict(lead=lead, device=device)
    if kind == ATTN:
        return KVCache.init(batch, cache_len, cfg.n_kv_heads, cfg.hd, dt, **kw)
    if kind == ATTN_SWA:
        w = min(cfg.sliding_window or cache_len, cache_len)
        return KVCache.init(batch, w, cfg.n_kv_heads, cfg.hd, dt, **kw)
    if kind == XATTN:
        # Cross KV is static per request; stored at its modality length.
        m = max(cfg.modality_tokens, 1)
        return KVCache.init(batch, m, cfg.n_kv_heads, cfg.hd, dt, **kw)
    if kind == MAMBA:
        return MambaState.init(batch, cfg.mamba_expand * cfg.d_model,
                               cfg.mamba_d_state, cfg.mamba_d_conv, dt, **kw)
    if kind == SLSTM:
        return SLSTMState.init(batch, cfg.n_heads,
                               cfg.d_model // cfg.n_heads, **kw)
    if kind == MLSTM:
        # The reference keeps this conv state in float32 (its init's
        # default), whatever the model's dtype.
        di = 2 * cfg.d_model
        return MLSTMState.init(batch, cfg.n_heads, di // cfg.n_heads, di,
                               **kw)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str | torch.device = "cpu") -> dict:
    """Decode cache: per pattern position, a cache or state stacked over
    the scanned super-blocks (zeros, no KV slot valid); ``cache_len``
    slots for ATTN, ``min(sliding_window, cache_len)`` for an ATTN_SWA
    ring, ``modality_tokens`` for XATTN; ``"first"``, unstacked, for a
    dense first block."""
    check_supported(cfg)
    cache: dict[str, Any] = {"layers": [
        _layer_cache(cfg, kind, batch, cache_len, (_n_scan(cfg),), device)
        for kind in cfg.block_pattern]}
    if cfg.first_layer_dense:
        cache["first"] = [_layer_cache(cfg, cfg.block_pattern[0], batch,
                                       cache_len, (), device)]
    return cache


def _decode_layer(p, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  pos: torch.Tensor, cache, moe_dispatch: str):
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind in (ATTN, ATTN_SWA):
        y, cache = attn_lib.attention_decode(p["attn"], h, pos, cache,
                                             theta=cfg.rope_theta,
                                             window=_window(cfg, kind))
    elif kind == XATTN:
        y = attn_lib.cross_decode(p["attn"], h, cache)
    elif kind == MAMBA:
        y, cache = mamba_lib.mamba_decode(p["mamba"], h, cache)
    elif kind == SLSTM:
        y, cache = xlstm_lib.slstm_decode(p["block"], h, cache)
        return x + y, cache
    elif kind == MLSTM:
        y, cache = xlstm_lib.mlstm_decode(p["block"], h, cache)
        return x + y, cache
    else:
        raise ValueError(kind)
    x = x + y
    if "norm2" in p:
        x = x + _apply_ffn(p, cfg, x, moe_dispatch=moe_dispatch)[0]
    return x, cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor, *,
                moe_dispatch: str = "capacity"):
    """One autoregressive step. tokens: (B, 1); pos: (B,). Returns
    (logits (B, 1, V), cache), the cache updated in place: KV caches take
    the token in place, new recurrent states are copied into the stacked
    ones.  MoE layers dispatch as ``moe_dispatch`` says (as in
    :func:`prefill`)."""
    _check_dispatch(moe_dispatch)
    x = embed(params["embed"], tokens)
    if cfg.first_layer_dense:
        x, c = _decode_layer(params["first_block"][0], cfg,
                             cfg.block_pattern[0], x, pos, cache["first"][0],
                             moe_dispatch)
        cache["first"] = [c]
    for i in range(_n_scan(cfg)):
        for p, kind, stacked in zip(_block(params, i), cfg.block_pattern,
                                    cache["layers"]):
            view = type(stacked)(**{f: getattr(stacked, f)[i]
                                    for f in _fields(stacked)})
            x, new = _decode_layer(p, cfg, kind, x, pos, view, moe_dispatch)
            if new is not view:
                for f in _fields(stacked):
                    getattr(stacked, f)[i].copy_(getattr(new, f))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x @ output_head(params, cfg), cache
