"""GQA attention: prefill through K11, and cached decode.

Port of ``repro/models/layers/attention.py`` for dense causal attention.
The prefill (``attention_block``) runs every causal self-attention over
sequential positions on :func:`repro_torch.kernels.ops.flash_attention_gqa`
(K11), which is what the reference's ``chunked_attention(causal=True,
window=None, sequential_positions=True)`` computes.  Decode attends one
query against a full :class:`KVCache` in plain PyTorch, as the reference
does (it has no decode kernel).

Layouts are the reference's: q (B, T, H, hd), k and v (B, T, KV, hd),
weights ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d).
Head h reads KV head h // (H / KV).

Sliding windows (ATTN_SWA, ring caches) and cross-attention wait for the
slice that ports ``chunked_attention`` and its backward with the LM
training stack (the LM training slice); they raise here.
"""
from __future__ import annotations

import dataclasses

import torch

from ...kernels import ops
from ...kernels.ref import NEG_INF, scale_queries
from .common import apply_rope, variance_scaling

_LATER = ("is ported with chunked_attention and its backward in the LM "
          "training slice of the LM stack")


# ------------------------------------------------------------------ params
def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, hd: int, *, qkv_bias: bool,
                   dtype: torch.dtype = torch.float32,
                   lead: tuple = ()) -> dict:
    """``lead`` prepends stacking axes (one draw per stacked layer)."""
    def w(shape, fan_in):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dtype)

    p = {"wq": w((d_model, n_heads, hd), d_model),
         "wk": w((d_model, n_kv_heads, hd), d_model),
         "wv": w((d_model, n_kv_heads, hd), d_model),
         "wo": w((n_heads, hd, d_model), n_heads * hd)}
    if qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros(lead + (n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (n_kv_heads, hd), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros(lead + (n_kv_heads, hd), dtype=dtype,
                              device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one (B·T, d) × (d, h·k) product."""
    return (x @ w.flatten(-2)).unflatten(-1, w.shape[-2:])


def qkv_proj(p, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p, o: torch.Tensor) -> torch.Tensor:
    """einsum("bthk,hkd->btd")."""
    return o.flatten(-2) @ p["wo"].flatten(0, 1)


# ------------------------------------------------------------------ oracle
def _mask(q_pos, kv_pos, kv_valid, *, causal: bool, window: int | None):
    m = kv_valid[None, :]
    diff = q_pos[:, None] - kv_pos[None, :]
    if causal:
        m = m & (diff >= 0)
    if window is not None:
        m = m & (diff < window)
    return m


def reference_attention(q, k, v, q_positions, kv_positions, kv_valid, *,
                        causal: bool, window: int | None) -> torch.Tensor:
    """O(T²)-memory oracle (the reference's ``reference_attention``)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = scale_queries(q).reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    mask = _mask(q_positions, kv_positions, kv_valid, causal=causal,
                 window=window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, :, None, None, None], p, 0.0)
    o = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Tq, H, hd)


# ------------------------------------------------------------------ decode
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     kv_valid: torch.Tensor, q_position: torch.Tensor, *,
                     window: int | None) -> torch.Tensor:
    """Single-step attention. q: (B, 1, H, hd); caches: (B, S, KV, hd);
    ``kv_positions``/``kv_valid`` (B, S); ``q_position`` (B,)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = scale_queries(q).reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    mask = kv_valid & (kv_positions <= q_position[:, None])
    if window is not None:
        mask = mask & (q_position[:, None] - kv_positions < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, hd)


# ------------------------------------------------------------------ caches
@dataclasses.dataclass
class KVCache:
    """Full KV cache of one layer, or of a stack of layers with a leading
    layer axis.  ``update`` writes in place (the reference returns a new
    cache): a layer's cache may be a view into the stacked tensors of
    :func:`repro_torch.models.transformer.init_cache`."""
    k: torch.Tensor          # (B, S, KV, hd)
    v: torch.Tensor
    positions: torch.Tensor  # (B, S) int32: absolute position in each slot
    valid: torch.Tensor      # (B, S) bool

    @staticmethod
    def init(batch: int, size: int, n_kv: int, hd: int, dtype, *,
             lead: tuple = (),
             device: str | torch.device = "cpu") -> "KVCache":
        shape = lead + (batch, size)
        return KVCache(
            k=torch.zeros(shape + (n_kv, hd), dtype=dtype, device=device),
            v=torch.zeros(shape + (n_kv, hd), dtype=dtype, device=device),
            positions=torch.zeros(shape, dtype=torch.int32, device=device),
            valid=torch.zeros(shape, dtype=torch.bool, device=device))

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views."""
        return KVCache(self.k[i], self.v[i], self.positions[i], self.valid[i])

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               pos: torch.Tensor) -> "KVCache":
        """Insert one token (k_new: (B, 1, KV, hd)) at slot pos % S, in
        place; returns ``self``."""
        S = self.k.shape[1]
        slot = (pos % S).long()
        b = torch.arange(self.k.shape[0], device=self.k.device)
        self.k[b, slot] = k_new[:, 0]
        self.v[b, slot] = v_new[:, 0]
        self.positions[b, slot] = pos.to(torch.int32)
        self.valid[b, slot] = True
        return self


def attention_block(p, x: torch.Tensor, positions: torch.Tensor, *,
                    theta: float, causal: bool = True,
                    window: int | None = None, return_kv: bool = False):
    """Full-sequence self-attention (prefill), attention on K11.

    ``positions`` (B, T) must be sequential, ``positions[b] = arange(T)``,
    as the prefill gives them: K11 places query row t at position t.
    ``return_kv=True`` also returns a :class:`KVCache` seeded with this
    sequence."""
    if window is not None:
        raise NotImplementedError(
            f"sliding-window attention (ATTN_SWA, window={window}) {_LATER}")
    B, T = x.shape[:2]
    q, k, v = qkv_proj(p, x)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    o = ops.flash_attention_gqa(q, k, v, causal=causal)
    out = out_proj(p, o)
    if not return_kv:
        return out
    posB = positions[:1].expand(B, T).to(torch.int32).contiguous()
    return out, KVCache(k=k, v=v, positions=posB,
                        valid=torch.ones((B, T), dtype=torch.bool,
                                         device=x.device))


def attention_decode(p, x: torch.Tensor, pos: torch.Tensor, cache: KVCache, *,
                     theta: float, window: int | None = None):
    """One-token decode. x: (B, 1, d); pos: (B,) current absolute position.
    Writes the token's k and v into ``cache`` in place."""
    q, k, v = qkv_proj(p, x)
    q = apply_rope(q, pos[:, None], theta)
    k = apply_rope(k, pos[:, None], theta)
    cache = cache.update(k, v, pos)
    o = decode_attention(q, cache.k, cache.v, cache.positions, cache.valid,
                         pos, window=window)
    return out_proj(p, o), cache


def cross_attention_block(*args, **kwargs):
    raise NotImplementedError(f"cross-attention (XATTN) {_LATER}")
