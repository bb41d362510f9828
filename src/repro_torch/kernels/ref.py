"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth of its Hopper kernel in
:mod:`repro_torch.kernels.graph_reg`, :mod:`~repro_torch.kernels.graph_reg_bsp`
or :mod:`~repro_torch.kernels.pairwise`: the CPU path runs them, and
``chip_smoke.py`` holds each kernel against them on the card.  The
regularizer's versions take an optional leading worker axis: ``logp``
(..., B, C), ``W`` (..., B, B).

The forward pair mirrors the reference oracles; the two backward closed
forms are the analytic VJP the reference's backward kernels tile:

    dlogp = g·[−gc·(P⊙(W·logP) + Wᵀ·P) + (κ + ge·deg)⊙P⊙(logP + 1)]
    dW    = −g·(gc·P·logPᵀ + ge·H(p)·1ᵀ)

The block-sparse versions (``bsp_*_ref``, K4–K7) take a worker axis —
``logp`` (k, B, C), ``W`` (k, B, B) — and the lists of a ``BlockLayout``
per worker: ``rows``/``cols``/``valid`` (k, T), ``crows``/``ccols``/
``cvalid`` (k, T), ``occ`` (k, nt, nt), nt = ceil(B / bt).  They walk the
lists as the kernels do: W's bt×bt tiles are gathered at the listed
(row, col) entries with ``valid == 1`` (sentinels and tail padding add
nothing), and every listed row strip owes its rows' entropy term once.

The graph-construction versions (K8, K9) take x (N, D) and y (M, D) and
form ``d2 = max(‖x‖² − 2·x·yᵀ + ‖y‖², 0)`` in float32, the reference's
formula.  ``knn_topk_ref`` is the dense oracle; ``knn_topk_stream_ref``
streams column chunks against a running (N, k) state, so the CPU path
never holds an N×M matrix either.  Both order each row by (d2, index),
ties to the lowest index, as the reference's ``lax.top_k`` does
(``torch.topk`` promises no order among ties, so they sort stably).
``knn_topk_segments_ref`` is the card kernel's split: per-segment lists of
column tiles, merged by rank (``merge_segment_lists``); it gives the same
lists, which is what lets the kernel merge in any order.

The attention version (K11) takes the reference's layout, q (B, Tq, H, hd)
against k, v (B, Tk, KV, hd), and repeats the arithmetic of its Pallas
kernel: q scaled by hd^-0.5 in q's own dtype, products summed in float32,
an online softmax over key tiles with NEG_INF = −1e30, p rounded to v's
dtype before P·V, the denominator clamped at 1e-30, the result cast to q's
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["graph_reg_pairwise_ref", "graph_regularizer_ref",
           "rbf_affinity_ref", "knn_topk_ref", "knn_topk_stream_ref",
           "reg_forward_ref", "reg_bwd_dlogp_ref", "reg_bwd_dw_ref",
           "bsp_forward_ref", "bsp_bwd_bterm_ref", "bsp_bwd_dlogp_ref",
           "flash_attention_ref", "scale_queries", "NEG_INF",
           "bsp_bwd_dw_ref", "knn_topk_segments_ref", "merge_segment_lists",
           "EMPTY"]


def graph_reg_pairwise_ref(logp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Σ_ij W_ij Hc(p_i, p_j) = −Σ W ⊙ (P·logPᵀ);  logp: (B, C), W: (B, B)."""
    p = torch.exp(logp)
    return -torch.sum(W * (p @ logp.mT), dim=(-2, -1))


def graph_regularizer_ref(logp: torch.Tensor, W: torch.Tensor,
                          gamma: float, kappa: float) -> torch.Tensor:
    """Full Eq.-3/4 regularizer:  γ Σ_ij W_ij Hc(p_i,p_j) − Σ_i (κ + γ Σ_j W_ij) H(p_i)."""
    return reg_forward_ref(logp, W, gamma, kappa, gamma)


def reg_forward_ref(logp: torch.Tensor, W: torch.Tensor, gc: float,
                    kappa: float, ge: float) -> torch.Tensor:
    """The fused forward with the kernel's scalar triple (gc, κ, ge)."""
    p = torch.exp(logp)
    cross = -torch.sum(W * (p @ logp.mT), dim=(-2, -1))
    deg = torch.sum(W, dim=-1)
    h = -torch.sum(p * logp, dim=-1)
    return gc * cross - torch.sum((kappa + ge * deg) * h, dim=-1)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """max(‖x_i‖² − 2·x_i·y_j + ‖y_j‖², 0) in float32, (N, M)."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp_min(xx - 2.0 * (x @ y.mT) + yy, 0.0)


def rbf_affinity_ref(x: torch.Tensor, y: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """exp(−‖x_i − y_j‖ / 2σ²) dense block;  x: (N, D), y: (M, D)."""
    sigma = torch.tensor(sigma, dtype=torch.float32)
    return torch.exp(-torch.sqrt(_sq_dists(x, y)) / (2.0 * sigma * sigma))


def _mask_self(d2: torch.Tensor, col0: int) -> None:
    """Set d2[i, i - col0] to inf, in place, for every row i of the chunk
    starting at column ``col0`` (the diagonal at offset −col0; a fill, so
    it can be captured in a CUDA graph)."""
    d2.diagonal(-col0).fill_(torch.inf)


def _smallest(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The k first (d2, idx) pairs of each row after a stable sort by d2:
    with ``idx`` increasing along each row, ties go to the lowest index."""
    d2, order = torch.sort(d2, dim=1, stable=True)
    return d2[:, :k], torch.gather(idx, 1, order[:, :k])


def knn_topk_ref(x: torch.Tensor, y: torch.Tensor, k: int, *,
                 exclude_self: bool = False):
    """k smallest squared distances per row via the dense (N, M) matrix:
    ``(d2, idx)``, (N, k) float32 and int32, sorted ascending — the ground
    truth the streaming kernel never materializes."""
    d2 = _sq_dists(x, y)
    if exclude_self:
        _mask_self(d2, 0)
    cols = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int32)
    return _smallest(d2, cols.expand(d2.shape), k)


def knn_topk_stream_ref(x: torch.Tensor, y: torch.Tensor, k: int, *,
                        exclude_self: bool = False, chunk: int = 1024):
    """:func:`knn_topk_ref` streamed over ``chunk``-wide column chunks: a
    running (N, k) top-k is merged with each (N, chunk) distance block in
    column order, so the (N, M) matrix is never held.  The running entries
    precede the chunk's and carry lower indices, so one stable sort per
    chunk keeps the (d2, index) order."""
    N, M = x.shape[0], y.shape[0]
    best_d = torch.empty((N, 0), device=x.device)
    best_i = torch.empty((N, 0), dtype=torch.int32, device=x.device)
    for c0 in range(0, M, chunk):
        d2 = _sq_dists(x, y[c0:c0 + chunk])
        if exclude_self:
            _mask_self(d2, c0)
        cols = torch.arange(c0, c0 + d2.shape[1], device=x.device,
                            dtype=torch.int32).expand(d2.shape)
        best_d, best_i = _smallest(torch.cat([best_d, d2], 1),
                                   torch.cat([best_i, cols], 1), k)
    return best_d.contiguous(), best_i.contiguous()


#: d2 of an unfilled slot of K8's lists (index −1): ``kEmpty`` in
#: ``csrc/pairwise.cu``.  Only a distance below it enters a list.
EMPTY = 3.4e38


def _before(d, i, e, j):
    """(d, i) before (e, j) in the total order (d2, index), elementwise."""
    return (d < e) | ((d == e) & (i < j))


def merge_segment_lists(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """K8's second pass: S lists per row, ``d2``/``idx`` (S, N, k), each
    sorted by (d2, index), merged into the first k of their union.  Entry
    t of list s goes to rank t + (entries of each lower list not after it)
    + (entries of each higher list before it): equal pairs (unfilled
    slots) go to the lower list, so the ranks are a permutation; ranks
    below k are written."""
    S, N, _ = d2.shape
    rank = torch.arange(k).expand(S, N, k).clone()
    for s in range(S):
        for o in range(S):
            if o != s:
                a, ai = d2[s][:, :, None], idx[s][:, :, None]
                b, bi = d2[o][:, None, :], idx[o][:, None, :]
                ahead = _before(b, bi, a, ai)
                if o < s:
                    ahead |= (b == a) & (bi == ai)
                rank[s] += ahead.sum(-1)
    keep = rank < k
    rows = torch.arange(N)[None, :, None].expand(S, N, k)
    out_d = torch.empty(N, k, dtype=d2.dtype)
    out_i = torch.empty(N, k, dtype=idx.dtype)
    out_d[rows[keep], rank[keep]] = d2[keep]
    out_i[rows[keep], rank[keep]] = idx[keep]
    return out_d, out_i


def knn_topk_segments_ref(x: torch.Tensor, y: torch.Tensor, k: int, *,
                          exclude_self: bool = False, segments: int = 1,
                          tile: int = 128):
    """:func:`knn_topk_ref` as the card's K8 splits it: the column tiles
    (``tile`` wide) in ``segments`` runs of ceil(tiles / segments), each
    run's k smallest (d2, index) below :data:`EMPTY`, padded with (EMPTY,
    −1), then :func:`merge_segment_lists`.  CPU tensors."""
    M = y.shape[0]
    n_tiles = -(-M // tile)
    seg_cols = -(-n_tiles // segments) * tile
    d2s, idxs = [], []
    for c0 in range(0, M, seg_cols):
        d2 = _sq_dists(x, y[c0:c0 + seg_cols])
        if exclude_self:
            _mask_self(d2, c0)
        cols = torch.arange(c0, c0 + d2.shape[1], dtype=torch.int32)
        d, i = _smallest(d2, cols.expand(d2.shape), min(k, d2.shape[1]))
        full = torch.full((x.shape[0], k), EMPTY, dtype=torch.float32)
        fi = torch.full((x.shape[0], k), -1, dtype=torch.int32)
        full[:, :d.shape[1]], fi[:, :d.shape[1]] = d, i
        empty = full >= EMPTY
        full[empty], fi[empty] = EMPTY, -1
        d2s.append(full)
        idxs.append(fi)
    return merge_segment_lists(torch.stack(d2s), torch.stack(idxs), k)


def _g(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Cotangent broadcast over the trailing (rows, cols) axes."""
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)[..., None, None]


def reg_bwd_dlogp_ref(logp: torch.Tensor, W: torch.Tensor, g, gc: float,
                      kappa: float, ge: float) -> torch.Tensor:
    """dL/dlogp of the fused forward, closed form."""
    p = torch.exp(logp)
    deg = torch.sum(W, dim=-1, keepdim=True)
    cross = p * (W @ logp) + W.mT @ p
    return _g(g, logp) * (-gc * cross + (kappa + ge * deg) * p * (logp + 1.0))


def reg_bwd_dw_ref(logp: torch.Tensor, g, gc: float, ge: float) -> torch.Tensor:
    """dL/dW of the fused forward, closed form (W itself is not read)."""
    p = torch.exp(logp)
    h = -torch.sum(p * logp, dim=-1, keepdim=True)
    return -_g(g, logp) * (gc * (p @ logp.mT) + ge * h)


def _strips(x: torch.Tensor, bt: int) -> torch.Tensor:
    """(k, B, ·) -> (k, nt, bt, ·), rows zero-padded to nt·bt."""
    k, B = x.shape[:2]
    nt = -(-B // bt)
    pad = [0, 0] * (x.dim() - 2) + [0, nt * bt - B]
    return F.pad(x, pad).reshape((k, nt, bt) + x.shape[2:])


def _tiles(W: torch.Tensor, bt: int) -> torch.Tensor:
    """(k, B, B) -> (k, nt, nt, bt, bt): W's tiles, zero-padded."""
    k, B = W.shape[:2]
    nt = -(-B // bt)
    n = nt * bt - B
    return F.pad(W, (0, n, 0, n)).reshape(k, nt, bt, nt, bt).transpose(2, 3)


def _pick(blocks: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``blocks[z, idx[0][z, t], ...]`` for each worker z: (k, T, ...)."""
    z = torch.arange(blocks.shape[0], device=blocks.device)[:, None]
    return blocks[(z,) + tuple(i.long() for i in idx)]


def _sum_into(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per worker, sum ``vals`` (k, T, ...) into n lines at ``idx`` (k, T)."""
    k = vals.shape[0]
    at = (idx.long() + n * torch.arange(k, device=idx.device)[:, None])
    out = vals.new_zeros((k * n,) + vals.shape[2:])
    out.index_add_(0, at.reshape(-1), vals.flatten(0, 1))
    return out.reshape((k, n) + vals.shape[2:])


def _listed_tiles(W, rows, cols, valid, bt) -> torch.Tensor:
    """W's tiles at the listed entries, zero where ``valid != 1``."""
    live = (valid == 1)[..., None, None]
    return torch.where(live, _pick(_tiles(W, bt), rows, cols), 0.0)


def bsp_forward_ref(logp, W, rows, cols, valid, bt: int, gc: float,
                    kappa: float, ge: float) -> torch.Tensor:
    """K4: the fused forward over the listed tiles, (k,)."""
    B = logp.shape[1]
    nt = -(-B // bt)
    p = torch.exp(logp)
    Wt = _listed_tiles(W, rows, cols, valid, bt)
    S = _pick(_strips(p, bt), rows) @ _pick(_strips(logp, bt), cols).mT
    cross = -torch.sum(Wt * S, dim=(1, 2, 3))
    deg = _sum_into(Wt.sum(-1), rows, nt)                     # (k, nt, bt)
    listed = _sum_into(W.new_ones(rows.shape), rows, nt) > 0
    h = _strips(-torch.sum(p * logp, dim=-1), bt)             # (k, nt, bt)
    ent = torch.sum(torch.where(listed[..., None], (kappa + ge * deg) * h,
                                0.0), dim=(1, 2))
    return gc * cross - ent


def bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid, bt: int) -> torch.Tensor:
    """K5: Wᵀ·P over the column-major list, (k, B, C)."""
    B = logp.shape[1]
    nt = -(-B // bt)
    Wt = _listed_tiles(W, crows, ccols, cvalid, bt)     # W[j-tile, i-tile]
    contrib = Wt.mT @ _pick(_strips(torch.exp(logp), bt), crows)
    return _sum_into(contrib, ccols, nt).flatten(1, 2)[:, :B].contiguous()


def bsp_bwd_dlogp_ref(logp, W, bterm, rows, cols, valid, g, bt: int,
                      gc: float, kappa: float, ge: float) -> torch.Tensor:
    """K6: dL/dlogp from W·logP and the degrees over the row-major list and
    K5's ``bterm``."""
    B = logp.shape[1]
    nt = -(-B // bt)
    p = torch.exp(logp)
    Wt = _listed_tiles(W, rows, cols, valid, bt)
    A = _sum_into(Wt @ _pick(_strips(logp, bt), cols), rows, nt)
    A = A.flatten(1, 2)[:, :B]
    deg = _sum_into(Wt.sum(-1), rows, nt).flatten(1, 2)[:, :B, None]
    return _g(g, logp) * (-gc * (p * A + bterm)
                          + (kappa + ge * deg) * p * (logp + 1.0))


def bsp_bwd_dw_ref(logp, occ, g, bt: int, gc: float, ge: float) -> torch.Tensor:
    """K7: K3's dL/dW on tiles with ``occ == 1``, exact zeros elsewhere."""
    B = logp.shape[-2]
    live = (occ == 1).repeat_interleave(bt, -2).repeat_interleave(bt, -1)
    return torch.where(live[..., :B, :B], reg_bwd_dw_ref(logp, g, gc, ge), 0.0)


#: The reference's mask value (``repro/kernels/flash_attention.py``).
NEG_INF = -1e30


def scale_queries(q: torch.Tensor) -> torch.Tensor:
    """q·hd^-0.5 in q's own dtype: the scale is rounded to that dtype first,
    as a weakly typed Python scalar is in the reference."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int | None = None,
                        block_k: int = 64,
                        causal_skip: bool = True) -> torch.Tensor:
    """K11: attention forward over key tiles of ``block_k``, q row t at
    absolute position ``q_offset + t`` (default Tk − Tq) and key j at j.
    Head h reads KV head h // (H / KV).  ``causal_skip``
    stops at the last tile that holds a key at or before the last query:
    the tiles after it are masked whole, so skipping them changes no bit
    (p = 0 and α = 1 on such a tile)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    off = Tk - Tq if q_offset is None else q_offset
    qs = scale_queries(q).float().reshape(B, Tq, KV, G, hd)
    kf, vf = k.float(), v.float()
    qpos = off + torch.arange(Tq, device=q.device)
    m = torch.full((B, Tq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((B, Tq, KV, G, hd), dtype=torch.float32,
                      device=q.device)
    end = min(Tk, off + Tq) if causal and causal_skip else Tk
    for j0 in range(0, end, block_k):
        j1 = min(j0 + block_k, Tk)
        s = torch.einsum("bqkgd,bskd->bqkgs", qs, kf[:, j0:j1])
        if causal:
            kpos = torch.arange(j0, j1, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(-1)
        pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(),
                          vf[:, j0:j1])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(lsum, 1e-30)[..., None]
    return out.reshape(B, Tq, H, hd).to(q.dtype)
