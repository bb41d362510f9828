"""GQA attention: chunked flash attention with its backward, the prefill's
K11 route, and cached decode.

Port of ``repro/models/layers/attention.py``.  ``chunked_attention`` is the
reference's training and windowed-prefill path: an online softmax over
(q block, kv block) tiles of a static, row-major tile list (tiles the
causal or window mask empties whole are skipped for sequential
positions), with a backward that recomputes each probability tile from q,
k and the saved log-sum-exp.  The reference writes it in jnp, not Pallas,
so it is plain PyTorch here, a ``torch.autograd.Function`` whose residuals
are O(T·H·hd).  The prefill of a layer without a window runs every causal
self-attention on :func:`repro_torch.kernels.ops.flash_attention_gqa`
(K11, forward only), and so does a windowed layer's (ATTN_SWA) while its
window covers the prompt (T ≤ window: the window masks no pair, so K11 is
exact there); a longer windowed prefill runs ``chunked_attention``.  Both
windowed prefills return the reference's ring-compacted cache.
Decode attends one query against a :class:`KVCache` (full, or a ring of
``window`` slots) in plain PyTorch, as the reference does.

Layouts are the reference's: q (B, T, H, hd), k and v (B, T, KV, hd),
weights ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d).
Head h reads KV head h // (H / KV).

Cross-attention (XATTN, Flamingo-style) attends to modality memory
projected once per request (:func:`cross_kv`) through
``chunked_attention`` without a causal mask, all query positions 0 and
the keys at ``arange(M)``, as the reference does; K11 stays off it (the
reference's kernel needs Tk % bk == 0 when it is not causal).  Its
output passes a tanh gate, a float32 scalar initialised to 0.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ... import spans
from ...kernels import ops
from ...kernels.ref import NEG_INF, scale_queries
from .common import apply_rope, variance_scaling


# ------------------------------------------------------------------ params
def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, hd: int, *, qkv_bias: bool,
                   dtype: torch.dtype = torch.float32,
                   lead: tuple = (),
                   device: str | torch.device | None = None) -> dict:
    """``lead`` prepends stacking axes (one draw per stacked layer);
    ``device`` defaults to the generator's."""
    dev = device or generator.device

    def w(shape, fan_in):
        return variance_scaling(generator, lead + shape, fan_in, dtype=dtype,
                                device=dev)

    p = {"wq": w((d_model, n_heads, hd), d_model),
         "wk": w((d_model, n_kv_heads, hd), d_model),
         "wv": w((d_model, n_kv_heads, hd), d_model),
         "wo": w((n_heads, hd, d_model), n_heads * hd)}
    if qkv_bias:
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


# ------------------------------------------------- chunked flash attention
def _mask_tile(q_pos, kv_pos, kv_valid, *, causal: bool,
               window: int | None):
    """(Tq_blk, Tk_blk) boolean mask for one tile from absolute positions."""
    m = kv_valid[None, :]
    diff = q_pos[:, None] - kv_pos[None, :]
    if causal:
        m = m & (diff >= 0)
    if window is not None:
        m = m & (diff < window)
    return m


def _flash_tile_shapes(q, k, q_block: int, kv_block: int):
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qb, kb = min(q_block, Tq), min(kv_block, Tk)
    return B, Tq, H, hd, Tk, KV, H // KV, qb, kb, (-Tq) % qb, (-Tk) % kb


def _tri_tile_list(nq: int, nk: int, qb: int, kb: int, Tq: int, Tk: int, *,
                   causal: bool, window: int | None,
                   sequential: bool) -> list[tuple[int, int]]:
    """Static (q_block, kv_block) tile list, row-major.

    With ``sequential`` positions (q = arange(Tq)+Tk−Tq, kv = arange(Tk)),
    fully-masked tiles are skipped: future tiles under causal masking and
    out-of-window tiles under a sliding window, which halves causal
    attention's work and makes a windowed prefill O(T·w).  Without it the
    full grid is listed (the same math: masks still apply per tile).

    ``Tq`` and ``Tk`` are the unpadded lengths.  The reference passes the
    lengths padded to whole blocks, which moves row 0's position by
    (−Tk) % kv_block − (−Tq) % q_block and, where that is not 0, skips
    tiles that hold unmasked keys (or keeps masked ones)."""
    off = Tk - Tq  # absolute position of q row 0
    tiles = []
    for i in range(nq):
        q_lo, q_hi = off + i * qb, off + (i + 1) * qb - 1
        for j in range(nk):
            k_lo, k_hi = j * kb, (j + 1) * kb - 1
            if sequential:
                if causal and k_lo > q_hi:
                    continue                       # entirely in the future
                if window is not None and k_hi < q_lo - window + 1:
                    continue                       # entirely out of window
            tiles.append((i, j))
    return tiles


def _rows_of(tiles: list[tuple[int, int]]) -> dict[int, list[int]]:
    """The tile list grouped by q block, in list order."""
    rows: dict[int, list[int]] = {}
    for i, j in tiles:
        rows.setdefault(i, []).append(j)
    return rows


def _pad(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zeros (False) appended along ``dim``."""
    if not n:
        return t
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _flash_fwd_tiles(q, k, v, q_positions, kv_positions, kv_valid, causal,
                     window, q_block, kv_block, sequential=False):
    """Tiled online-softmax forward -> (out (B, Tq, H, hd) in v's dtype,
    lse (B, Tq, H) float32).

    Each q block walks its kv tiles in list order with the running max,
    sum and float32 accumulator of the reference's scan; products of
    bf16 inputs are taken in float32 (exact products, float32 sums), as
    the reference's ``preferred_element_type=float32`` gives them."""
    B, Tq, H, hd, Tk, KV, G, qb, kb, pq, pk = _flash_tile_shapes(
        q, k, q_block, kv_block)
    qs = _pad(scale_queries(q), 1, pq).float().reshape(B, Tq + pq, KV, G,
                                                       hd)
    qp = _pad(q_positions, 0, pq)
    kf, vf = _pad(k, 1, pk).float(), _pad(v, 1, pk).float()
    kp, kval = _pad(kv_positions, 0, pk), _pad(kv_valid, 0, pk)
    nq, nk = (Tq + pq) // qb, (Tk + pk) // kb
    tiles = _tri_tile_list(nq, nk, qb, kb, Tq, Tk, causal=causal,
                           window=window, sequential=sequential)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.zeros((B, Tq + pq, KV, G, hd), dtype=v.dtype, device=q.device)
    lse = torch.zeros((B, Tq + pq, KV, G), **f32)
    for i, cols in _rows_of(tiles).items():
        rows = slice(i * qb, (i + 1) * qb)
        qi = qs[:, rows]
        acc = torch.zeros((B, qb, KV, G, hd), **f32)
        m = torch.full((B, qb, KV, G), NEG_INF, **f32)
        lsum = torch.zeros((B, qb, KV, G), **f32)
        for j in cols:
            span = slice(j * kb, (j + 1) * kb)
            s = torch.einsum("bqkgd,bskd->bqkgs", qi, kf[:, span])
            mask = _mask_tile(qp[rows], kp[span], kval[span], causal=causal,
                              window=window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(-1)
            pv = torch.einsum("bqkgs,bskd->bqkgd", p, vf[:, span])
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, rows] = (acc / lsum.clamp_min(1e-30)[..., None]).to(v.dtype)
        lse[:, rows] = torch.where(lsum > 0,
                                   m + torch.log(lsum.clamp_min(1e-30)), 0.0)
    return (out.reshape(B, Tq + pq, H, hd)[:, :Tq],
            lse.reshape(B, Tq + pq, H)[:, :Tq])


def _flash_bwd_tiles(res, do, causal, window, q_block, kv_block,
                     sequential=False):
    """Flash backward over the forward's tile list: each tile's p is
    recomputed from q, k and lse (O(T) residual memory), and dq, dk and dv
    are summed in float32 tile by tile.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    q, k, v, q_positions, kv_positions, kv_valid, out, lse = res
    B, Tq, H, hd, Tk, KV, G, qb, kb, pq, pk = _flash_tile_shapes(
        q, k, q_block, kv_block)
    scale = hd ** -0.5
    shape5 = (B, Tq + pq, KV, G, hd)
    qf = _pad(q, 1, pq).float().reshape(shape5)
    dof = _pad(do, 1, pq).float().reshape(shape5)
    outf = _pad(out, 1, pq).float().reshape(shape5)
    lsef = _pad(lse, 1, pq).reshape(shape5[:-1])
    qp = _pad(q_positions, 0, pq)
    kf, vf = _pad(k, 1, pk).float(), _pad(v, 1, pk).float()
    kp, kval = _pad(kv_positions, 0, pk), _pad(kv_valid, 0, pk)
    nq, nk = (Tq + pq) // qb, (Tk + pk) // kb
    tiles = _tri_tile_list(nq, nk, qb, kb, Tq, Tk, causal=causal,
                           window=window, sequential=sequential)
    dq = torch.zeros(shape5, dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Tk + pk, KV, hd), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for i, cols in _rows_of(tiles).items():
        rows = slice(i * qb, (i + 1) * qb)
        qi, doi = qf[:, rows], dof[:, rows]
        di = torch.sum(doi * outf[:, rows], -1)
        lsei = lsef[:, rows]
        for j in cols:
            span = slice(j * kb, (j + 1) * kb)
            ki, vi = kf[:, span], vf[:, span]
            s = torch.einsum("bqkgd,bskd->bqkgs", qi, ki) * scale
            mask = _mask_tile(qp[rows], kp[span], kval[span], causal=causal,
                              window=window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            p = torch.exp(s - lsei[..., None])
            dv[:, span] += torch.einsum("bqkgs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bqkgs", doi, vi)
            ds = p * (dp - di[..., None])
            dq[:, rows] += scale * torch.einsum("bqkgs,bskd->bqkgd", ds, ki)
            dk[:, span] += scale * torch.einsum("bqkgs,bqkgd->bskd", ds, qi)
    return (dq.reshape(B, Tq + pq, H, hd)[:, :Tq].to(q.dtype),
            dk[:, :Tk].to(k.dtype), dv[:, :Tk].to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the tiled forward keeps out and lse,
    the backward recomputes the probability tiles from them."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, kv_valid, causal,
                window, q_block, kv_block, sequential):
        out, lse = _flash_fwd_tiles(q, k, v, q_positions, kv_positions,
                                    kv_valid, causal, window, q_block,
                                    kv_block, sequential)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, kv_valid,
                              out, lse)
        ctx.statics = (causal, window, q_block, kv_block, sequential)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd_tiles(ctx.saved_tensors, do.contiguous(),
                                      *ctx.statics)
        return (dq, dk, dv) + (None,) * 8


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      kv_valid: torch.Tensor, *, causal: bool,
                      window: int | None, q_block: int = 512,
                      kv_block: int = 1024,
                      sequential_positions: bool = False) -> torch.Tensor:
    """Flash attention (online softmax over kv tiles, recomputing backward).

    q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd); positions are (T,) absolute
    and ``kv_valid`` (Tk,) bool.  H must be a multiple of KV (GQA).
    Returns (B, Tq, H, hd) in v's dtype.  Residual memory is O(T·H·hd)
    (out and lse), not O(T²).  ``sequential_positions=True`` (callers
    with arange positions) skips the tiles the masks empty whole."""
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                 kv_valid, causal, window, q_block, kv_block,
                                 sequential_positions)


def reference_attention(q, k, v, q_positions, kv_positions, kv_valid, *,
                        causal: bool, window: int | None) -> torch.Tensor:
    """O(T²)-memory oracle (the reference's ``reference_attention``)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = scale_queries(q).reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    mask = _mask_tile(q_positions, kv_positions, kv_valid, causal=causal,
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
    """Full-sequence self-attention (training forward and prefill).

    ``positions`` (B, T) must be sequential, ``positions[b] = arange(T)``.
    ``return_kv=True`` (the prefill) also returns a :class:`KVCache`
    seeded with this sequence: full length without a window, where the
    attention runs on K11 (forward only); ring-compacted to exactly
    ``window`` slots with one (ATTN_SWA), the slot of position p at
    p % window as :meth:`KVCache.update` places it, the attention on K11
    too while T ≤ window.  Every other call runs :func:`chunked_attention`,
    which has a backward."""
    B, T = x.shape[:2]
    with spans.span("attn.qkv"):
        q, k, v = qkv_proj(p, x)
    with spans.span("attn.rope", device=True):
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    pos1d = positions[0]
    if return_kv and (window is None or T <= window):
        o = ops.flash_attention_gqa(q, k, v, causal=causal)
    else:
        o = chunked_attention(q, k, v, pos1d, pos1d,
                              torch.ones_like(pos1d, dtype=torch.bool),
                              causal=causal, window=window,
                              sequential_positions=True)
    with spans.span("attn.out"):
        out = out_proj(p, o)
    if not return_kv:
        return out
    with spans.span("attn.cache"):
        posB = pos1d[None].expand(B, T).to(torch.int32).contiguous()
        valid = torch.ones((B, T), dtype=torch.bool, device=x.device)
        if window is None:
            cache = KVCache(k=k, v=v, positions=posB, valid=valid)
        elif T <= window:
            # A ring cache is exactly `window` slots; slot p % window == p.
            pad = window - T
            cache = KVCache(k=F.pad(k, (0, 0, 0, 0, 0, pad)),
                            v=F.pad(v, (0, 0, 0, 0, 0, pad)),
                            positions=F.pad(posB, (0, pad)),
                            valid=F.pad(valid, (0, pad)))
        else:
            # The last `window` tokens, at slot (position % window): slot s
            # holds source index T - window + (s - T) % window.
            s = torch.arange(window, device=x.device)
            src = T - window + (s - T) % window
            cache = KVCache(k=k[:, src], v=v[:, src], positions=posB[:, src],
                            valid=valid[:, :window])
    return out, cache


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


# ------------------------------------------------------------ cross-attn
def init_cross_attention(generator: torch.Generator, d_model: int,
                         n_heads: int, n_kv_heads: int, hd: int, *,
                         dtype: torch.dtype = torch.float32,
                         lead: tuple = (),
                         device: str | torch.device | None = None) -> dict:
    """Attention weights without biases and a float32 ``gate`` of 0 (a
    tanh-gated residual)."""
    p = init_attention(generator, d_model, n_heads, n_kv_heads, hd,
                       qkv_bias=False, dtype=dtype, lead=lead, device=device)
    p["gate"] = torch.zeros(lead, dtype=torch.float32,
                            device=device or generator.device)
    return p


def gated_out(p, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tanh(gate) · out_proj(o), in float32, cast to ``dtype``."""
    return (torch.tanh(p["gate"]) * out_proj(p, o).float()).to(dtype)


def cross_attention_block(p, x: torch.Tensor, mem_k: torch.Tensor,
                          mem_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, T, d) to precomputed memory k, v (B, M,
    KV, hd): every query at position 0, keys at 0..M−1, no causal mask."""
    q = _proj(x, p["wq"])
    M = mem_k.shape[1]
    pos = torch.arange(M, device=x.device)
    o = chunked_attention(q, mem_k, mem_v,
                          torch.zeros(x.shape[1], dtype=torch.long,
                                      device=x.device), pos,
                          torch.ones(M, dtype=torch.bool, device=x.device),
                          causal=False, window=None)
    return gated_out(p, o, x.dtype)


def cross_kv(p, mem: torch.Tensor):
    """Project modality memory once: (B, M, d) -> k, v (B, M, KV, hd)."""
    return _proj(mem, p["wk"]), _proj(mem, p["wv"])


def cross_decode(p, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One token's cross-attention to the cached memory k, v: the query at
    position int32 max − 1, so every valid slot is visible."""
    pos = torch.full((x.shape[0],), torch.iinfo(torch.int32).max - 1,
                     dtype=torch.int32, device=x.device)
    o = decode_attention(_proj(x, p["wq"]), cache.k, cache.v,
                         cache.positions, cache.valid, pos, window=None)
    return gated_out(p, o, x.dtype)
