"""Block-sparse graph regularizer (K4–K7) of the port against the reference.

The same numpy inputs go through the reference's
``repro.kernels.ops.graph_regularizer_blocksparse`` (its Pallas kernels in
interpret mode on the CPU, as tests/test_blocksparse.py runs them) and
through the port's entry, whose wrappers run the plain versions of K4–K7
on CPU tensors behind the same ``torch.autograd.Function`` the GPU path
uses.  Forward values, ``dlogp`` and ``dW`` (``jax.vjp`` against
``torch.autograd``) must agree; the plain versions walk the layout's tile
lists, so the list contract itself is under test, and they are also held
to the reference's kernels called directly and to the dense plain
versions.

Tolerances: both sides sum float32 products in different orders (tiles
of the Pallas grid against gathered tiles and one matmul per tile), so
values agree to ~1e-6 relative; the tests allow rtol 2e-5 with an atol of
2e-5 of the largest magnitude, as tests/test_torch_graph_reg.py does.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import race_audit as jaudit  # noqa: E402
from repro.core import metabatch as jmeta  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.graph_reg import (  # noqa: E402
    graph_reg_blocksparse_bwd_pallas, graph_reg_blocksparse_pallas)
from repro.kernels.tuning import TileSpec as JTileSpec  # noqa: E402
from repro_torch.analysis import race_audit as taudit  # noqa: E402
from repro_torch.core import metabatch as tmeta  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import graph_reg_bsp as bsp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.tuning import TileSpec, refuse_pinned  # noqa: E402

RTOL = 2e-5
GAMMA, KAPPA = 0.31, 2e-3
SHAPES = [(77, 23, 32), (128, 39, 32), (130, 70, 64), (96, 8, 32)]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _problem(B, C, bt, seed=0, density=0.5, occ=None):
    """(logp, W, occ): W zero outside a random symmetric tile mask."""
    rng = np.random.default_rng(seed + 7 * B + C + bt)
    logits = rng.normal(size=(B, C)).astype(np.float32) * 2.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)), np.float32)
    W = np.abs(rng.normal(size=(B, B))).astype(np.float32)
    W = (W + W.T) / 2
    nt = -(-B // bt)
    if occ is None:
        occ = rng.random((nt, nt)) < density
        occ = occ | occ.T
    mask = np.kron(occ, np.ones((bt, bt), bool))[:B, :B]
    return logp, np.where(mask, W, 0.0).astype(np.float32), mask


def _jax_value_and_vjp(logp, W, lay, bt, g):
    f = lambda lp, w: jops.graph_regularizer_blocksparse(  # noqa: E731
        lp, w, GAMMA, KAPPA, layout=lay, tiles=JTileSpec(bi=bt, bc=16))
    val, vjp = jax.vjp(f, jnp.asarray(logp), jnp.asarray(W))
    return (float(val),) + tuple(np.asarray(a) for a in vjp(jnp.float32(g)))


def _torch_value_and_vjp(logp, W, layout, g, **kw):
    lp = torch.tensor(logp, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    val = ops.graph_regularizer_blocksparse(lp, w, GAMMA, KAPPA,
                                            layout=layout, **kw)
    dlp, dw = torch.autograd.grad(val, (lp, w), torch.tensor(g))
    return val.item(), dlp.numpy(), dw.numpy()


@pytest.mark.parametrize("B,C,bt", SHAPES)
def test_entry_forward_and_vjp_match_jax(B, C, bt):
    """Unaligned B and C; the port's own BlockLayout with its bt."""
    logp, W, mask = _problem(B, C, bt)
    jlay = jmeta.block_layout(W, bt)
    want = _jax_value_and_vjp(logp, W, jlay, bt, 0.37)
    got = _torch_value_and_vjp(logp, W, tmeta.block_layout(W, bt), 0.37)
    for a, b in zip(got, want):
        _close(a, b)
    assert np.all(got[2][~mask] == 0.0)


@pytest.mark.parametrize("B,C,bt", SHAPES[:2])
def test_layout_as_arrays_with_pinned_bi(B, C, bt):
    """The 7-tuple (numpy or tensors) with the tile edge from tiles.bi, as
    the training step hands it over."""
    logp, W, _ = _problem(B, C, bt, seed=1)
    arrays = tmeta.block_layout(W, bt).arrays()
    want = _torch_value_and_vjp(logp, W, tmeta.block_layout(W, bt), 1.0)
    for layout in (arrays, [torch.from_numpy(a) for a in arrays]):
        got = _torch_value_and_vjp(logp, W, layout, 1.0,
                                   tiles=TileSpec(bi=bt))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,C,bt", SHAPES)
@pytest.mark.parametrize("triple", [(GAMMA, KAPPA, GAMMA), (1.0, 0.0, 0.0)])
def test_plain_versions_match_jax_kernels(triple, B, C, bt):
    """K4's plain version against ``_bsp_forward``, K5∘K6's and K7's
    against ``_bsp_bwd`` (interpret mode), on the same lists."""
    gc, kappa, ge = triple
    logp, W, _ = _problem(B, C, bt, seed=2)
    lay = jmeta.block_layout(W, bt)
    arrs = [jnp.asarray(a) for a in lay.arrays()]
    g = 1.3
    want_fwd = graph_reg_blocksparse_pallas(
        jnp.asarray(logp), jnp.asarray(W), *arrs[:3], gc, kappa,
        ent_weight=ge, bt=bt, bc=16)
    want_dlogp, want_dW = graph_reg_blocksparse_bwd_pallas(
        jnp.asarray(logp), jnp.asarray(W), jnp.float32(g), *arrs,
        gamma=gc, kappa=kappa, ent_weight=ge, bt=bt, bc=16)
    lp, w = torch.tensor(logp)[None], torch.tensor(W)[None]
    rows, cols, valid, crows, ccols, cvalid, occ = [
        torch.from_numpy(a)[None] for a in tmeta.block_layout(W, bt).arrays()]
    gt = torch.tensor([g])
    _close(ref.bsp_forward_ref(lp, w, rows, cols, valid, bt, gc, kappa,
                               ge).item(), float(want_fwd))
    bterm = ref.bsp_bwd_bterm_ref(lp, w, crows, ccols, cvalid, bt)
    _close(ref.bsp_bwd_dlogp_ref(lp, w, bterm, rows, cols, valid, gt, bt, gc,
                                 kappa, ge)[0].numpy(), want_dlogp)
    _close(ref.bsp_bwd_dw_ref(lp, occ, gt, bt, gc, ge)[0].numpy(), want_dW)


@pytest.mark.parametrize("B,C,bt", SHAPES)
def test_plain_versions_match_dense_plain_versions(B, C, bt):
    """With exact occupancy the list walk computes the dense function:
    K4 = K1, K5∘K6 = K2 and K7 = K3 (on the occupied tiles), plain."""
    logp, W, mask = _problem(B, C, bt, seed=3)
    lp, w = torch.tensor(logp)[None], torch.tensor(W)[None]
    rows, cols, valid, crows, ccols, cvalid, occ = [
        torch.from_numpy(a)[None] for a in tmeta.block_layout(W, bt).arrays()]
    g = torch.tensor([0.7])
    _close(ref.bsp_forward_ref(lp, w, rows, cols, valid, bt, GAMMA, KAPPA,
                               GAMMA).item(),
           ref.reg_forward_ref(lp, w, GAMMA, KAPPA, GAMMA).item())
    bterm = ref.bsp_bwd_bterm_ref(lp, w, crows, ccols, cvalid, bt)
    _close(bterm.numpy(), (w.mT @ torch.exp(lp)).numpy())
    _close(ref.bsp_bwd_dlogp_ref(lp, w, bterm, rows, cols, valid, g, bt,
                                 GAMMA, KAPPA, GAMMA).numpy(),
           ref.reg_bwd_dlogp_ref(lp, w, g, GAMMA, KAPPA, GAMMA).numpy())
    dw = ref.bsp_bwd_dw_ref(lp, occ, g, bt, GAMMA, GAMMA)[0].numpy()
    np.testing.assert_array_equal(
        dw, np.where(mask, ref.reg_bwd_dw_ref(lp, g, GAMMA, GAMMA)[0].numpy(),
                     0.0))


def test_empty_mask_keeps_entropy_term():
    """All-zero W: every tile row is a sentinel, the pairwise terms vanish,
    and only the κ·H(p) term survives, with its gradient."""
    B, C, bt = 96, 8, 32
    logp, _, _ = _problem(B, C, bt, seed=4)
    W = np.zeros((B, B), np.float32)
    jlay, tlay = jmeta.block_layout(W, bt), tmeta.block_layout(W, bt)
    assert tlay.n_active == 0 and tlay.list_len >= tlay.nt
    want = _jax_value_and_vjp(logp, W, jlay, bt, 1.0)
    got = _torch_value_and_vjp(logp, W, tlay, 1.0)
    for a, b in zip(got, want):
        _close(a, b)
    p = np.exp(logp.astype(np.float64))
    _close(got[0], KAPPA * np.sum(p * logp))
    assert np.all(got[2] == 0.0)


def test_empty_tile_row_inside_sparse_mask():
    """A sparse mask whose middle tile row and column are empty: the
    sentinel's rows still get their entropy term and a defined dlogp."""
    B, C, bt = 96, 10, 32
    occ = np.zeros((3, 3), bool)
    occ[0, 0] = occ[2, 2] = occ[0, 2] = occ[2, 0] = True
    logp, W, _ = _problem(B, C, bt, seed=5, occ=occ)
    tlay = tmeta.block_layout(W, bt)
    assert (tlay.rows == 1).sum() == 1 and tlay.valid[tlay.rows == 1] == 0
    want = _jax_value_and_vjp(logp, W, jmeta.block_layout(W, bt), bt, 1.0)
    got = _torch_value_and_vjp(logp, W, tlay, 1.0)
    for a, b in zip(got, want):
        _close(a, b)
    assert np.all(np.isfinite(got[1]))


def test_full_mask_equals_fused_entry():
    """Every tile occupied: the block-sparse entry computes the dense fused
    entry's value and gradients (bit for bit only on the card, where K4
    and K1 share their loops; the plain versions sum in other orders)."""
    B, C, bt = 128, 16, 32
    logp, W, _ = _problem(B, C, bt, seed=6, density=2.0)
    lay = tmeta.block_layout(W, bt)
    assert lay.density == 1.0 and lay.nt > 1
    got = _torch_value_and_vjp(logp, W, lay, 1.0)
    lp = torch.tensor(logp, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    val = ops.graph_regularizer_fused(lp, w, GAMMA, KAPPA)
    want = (val.item(),) + tuple(
        a.numpy() for a in torch.autograd.grad(val, (lp, w)))
    for a, b in zip(got, want):
        _close(a, b)


def test_single_tile_grid_falls_back_to_dense(monkeypatch):
    """nt == 1 has nothing to skip: the entry routes to the dense fused
    Function (bit-identical result) and never reaches K4–K7."""
    def boom(*a, **k):
        raise AssertionError("a block-sparse kernel ran on a 1x1 tile grid")
    for name in ("bsp_forward", "bsp_bwd_bterm", "bsp_bwd_dlogp",
                 "bsp_bwd_dw"):
        monkeypatch.setattr(bsp, name, boom)
    B, C, bt = 64, 8, 64
    logp, W, _ = _problem(B, C, bt, seed=7, density=2.0)
    lay = tmeta.block_layout(W, bt)
    assert lay.nt == 1
    got = _torch_value_and_vjp(logp, W, lay, 1.0, tiles=TileSpec(bi=bt))
    lp = torch.tensor(logp, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    val = ops.graph_regularizer_fused(lp, w, GAMMA, KAPPA)
    want = (val.item(),) + tuple(
        a.numpy() for a in torch.autograd.grad(val, (lp, w)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_worker_axis_equals_per_worker_calls():
    """k = 2 stacked layouts (one list length, as the pipeline pins it)
    give each worker's value and gradients as separate calls would."""
    B, C, bt, k = 96, 12, 32, 2
    probs = [_problem(B, C, bt, seed=10 + z) for z in range(k)]
    T = max(tmeta.block_layout(W, bt).list_len for _, W, _ in probs)
    lays = [tmeta.block_layout(W, bt, list_len=T) for _, W, _ in probs]
    stacked = [np.stack([lay.arrays()[i] for lay in lays]) for i in range(7)]
    lp = torch.tensor(np.stack([p[0] for p in probs]), requires_grad=True)
    w = torch.tensor(np.stack([p[1] for p in probs]), requires_grad=True)
    out = ops.graph_regularizer_blocksparse(lp, w, GAMMA, KAPPA,
                                            layout=stacked,
                                            tiles=TileSpec(bi=bt))
    assert out.shape == (k,)
    cot = torch.tensor([0.5, -2.0])
    dlp, dw = torch.autograd.grad(out, (lp, w), cot)
    for z, (logp, W, _) in enumerate(probs):
        got = _torch_value_and_vjp(logp, W, lays[z], float(cot[z]))
        _close(out[z].item(), got[0], rtol=1e-6)
        _close(dlp[z].numpy(), got[1], rtol=1e-6)
        _close(dw[z].numpy(), got[2], rtol=1e-6)


def test_dw_is_exactly_zero_off_the_mask():
    B, C, bt = 130, 20, 32
    logp, W, mask = _problem(B, C, bt, seed=8, density=0.3)
    _, _, dw = _torch_value_and_vjp(logp, W, tmeta.block_layout(W, bt), 2.0)
    assert np.all(dw[~mask] == 0.0) and np.any(dw[mask] != 0.0)


def test_backward_skips_k7_when_w_needs_no_gradient(monkeypatch):
    """Training's W is batch data: the backward runs K5 and K6, not K7."""
    def boom(*a, **k):
        raise AssertionError("bsp_bwd_dw called though W needs no gradient")
    monkeypatch.setattr(bsp, "bsp_bwd_dw", boom)
    logp, W, _ = _problem(96, 8, 32, seed=9)
    lp = torch.tensor(logp, requires_grad=True)
    ops.graph_regularizer_blocksparse(
        lp, torch.tensor(W), GAMMA, KAPPA,
        layout=tmeta.block_layout(W, 32)).backward()
    assert torch.isfinite(lp.grad).all()


def _bad_layouts():
    """(name, port layout, reference layout) pairs, good and corrupted."""
    rng = np.random.default_rng(0)
    occ = rng.random((5, 5)) < 0.4
    occ[2, :] = False
    out = []
    for name, fix in [
            ("good", lambda f: f),
            ("duplicate", lambda f: dict(f, rows=np.r_[f["rows"][:1],
                                                       f["rows"][:-1]],
                                         cols=np.r_[f["cols"][:1],
                                                    f["cols"][:-1]],
                                         valid=np.r_[f["valid"][:1],
                                                     f["valid"][:-1]])),
            ("out_of_order", lambda f: dict(f, rows=f["rows"][::-1].copy(),
                                            cols=f["cols"][::-1].copy(),
                                            valid=f["valid"][::-1].copy())),
            ("missing_sentinel", lambda f: dict(
                f, crows=f["crows"][f["ccols"] != 2],
                ccols=f["ccols"][f["ccols"] != 2],
                cvalid=f["cvalid"][f["ccols"] != 2])),
            ("occ_mismatch", lambda f: dict(f, occ=np.ones_like(f["occ"])))]:
        pair = []
        for meta in (tmeta, jmeta):
            lay = meta.layout_from_occupancy(occ, 32, list_len=24)
            fields = {k: getattr(lay, k) for k in (
                "rows", "cols", "valid", "crows", "ccols", "cvalid", "occ")}
            pair.append(dataclasses.replace(lay, **fix(fields)))
        out.append((name, *pair))
    return out


@pytest.mark.parametrize("name,tlay,jlay", _bad_layouts(),
                         ids=[c[0] for c in _bad_layouts()])
def test_copied_checks_give_the_reference_verdicts(name, tlay, jlay):
    got = taudit.check_layout(tlay, where="t")
    want = jaudit.check_layout(jlay, where="t")
    assert [(f.rule, f.detail, f.message) for f in got] == \
        [(f.rule, f.detail, f.message) for f in want]
    assert bool(got) == (name != "good")


@pytest.mark.parametrize("corrupt,rule", [("duplicate", "W002"),
                                          ("out_of_order", "W003")])
def test_validate_raises_on_broken_lists(corrupt, rule):
    (_, tlay, _), = [c for c in _bad_layouts() if c[0] == corrupt]
    B, C = 5 * 32, 8
    logp, W, _ = _problem(B, C, 32, seed=11, occ=tlay.occ.astype(bool))
    for layout in (tlay, tlay.arrays()):
        with pytest.raises(ValueError, match=rule):
            ops.graph_regularizer_blocksparse(
                torch.tensor(logp), torch.tensor(W), GAMMA, KAPPA,
                layout=layout, tiles=TileSpec(bi=32), validate=True)
    good = tmeta.block_layout(W, 32)
    out = ops.graph_regularizer_blocksparse(
        torch.tensor(logp), torch.tensor(W), GAMMA, KAPPA, layout=good,
        validate=True)
    assert torch.isfinite(out)


def test_layout_grid_must_match_the_tile_edge():
    logp, W, _ = _problem(96, 8, 32, seed=12)
    with pytest.raises(ValueError, match="does not match"):
        ops.graph_regularizer_blocksparse(
            torch.tensor(logp), torch.tensor(W), GAMMA, KAPPA,
            layout=tmeta.block_layout(W, 32).arrays(), tiles=TileSpec(bi=64))


def test_tile_edge_rule_and_pinned_tiles_on_the_card_path():
    """What the CUDA path refuses (checked here without a card): a tile
    edge that is not a multiple of 32, and any pinned size but bi = bt.
    The plain versions take any bt."""
    for bt in (32, 64, 96, 128):
        bsp.check_tile_edge(bt)
    for bt in (0, 16, 48, 100):
        with pytest.raises(ValueError, match="multiple of 32"):
            bsp.check_tile_edge(bt)
    refuse_pinned(TileSpec(bi=128), "k", bi=128)
    for tiles in (TileSpec(bi=64), TileSpec(bi=128, bc=16)):
        with pytest.raises(ValueError, match="only bi=128"):
            refuse_pinned(tiles, "k", bi=128)
    logp, W, _ = _problem(96, 8, 48, seed=13)
    got = _torch_value_and_vjp(logp, W, tmeta.block_layout(W, 48), 1.0)
    want = _jax_value_and_vjp(logp, W, jmeta.block_layout(W, 48), 48, 1.0)
    for a, b in zip(got, want):
        _close(a, b)


def test_launch_counters_cover_k4_to_k7_and_ignore_the_plain_path():
    gr.reset_launch_counts()
    logp, W, _ = _problem(96, 8, 32, seed=14)
    lp = torch.tensor(logp, requires_grad=True)
    ops.graph_regularizer_blocksparse(
        lp, torch.tensor(W, requires_grad=True), GAMMA, KAPPA,
        layout=tmeta.block_layout(W, 32)).backward()
    counts = gr.launch_counts()
    assert set(counts) >= set(bsp.WRAPPERS) and not any(counts.values())


# K4's and K6's launch plans (``graph_reg_bsp_fwd_plan`` and
# ``graph_reg_bsp_dlogp_plan`` in the source) have Python mirrors,
# ``bsp.fwd_plan`` and ``bsp.dlogp_plan``: their constants are held to the
# sources here and their results to the library on the card
# (tests/test_torch_kernels_cuda.py).
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
_PLAN_CONSTANTS = {
    "fwd_span": ("graph_reg_tiles.cuh", "kFwdSpan", bsp.FWD_SPAN),
    "fwd_chunk": ("graph_reg_tiles.cuh", "kFwdChunk", bsp.FWD_CHUNK),
    "fwd_stages": ("graph_reg_tiles.cuh", "kFwdStages", bsp.FWD_STAGES),
    "fwd_max_pairs": ("graph_reg_tiles.cuh", "kFwdMaxPairs",
                      bsp.FWD_MAX_PAIRS),
    "strip_partials": ("graph_reg_tiles.cuh", "kThreads", bsp.SUM_THREADS),
    "dl_piece": ("graph_reg_tiles.cuh", "kDlPiece", bsp.DL_PIECE),
    "dl_max_rows": ("graph_reg_tiles.cuh", "kDlMaxRows", bsp.DL_MAX_ROWS),
    "dl_max_quads": ("graph_reg_tiles.cuh", "kDlMaxQuads", bsp.DL_MAX_QUADS),
    "dl_max_threads": ("graph_reg_tiles.cuh", "kDlMaxThreads",
                       bsp.DL_MAX_THREADS),
    "dlogp_stages": ("graph_reg_bsp.cu", "kBsDlStages", bsp.DLOGP_STAGES),
}


@pytest.mark.parametrize("name", sorted(_PLAN_CONSTANTS))
def test_bsp_launch_plan_mirror_constants_follow_the_source(name):
    fname, const, value = _PLAN_CONSTANTS[name]
    src = (CSRC / fname).read_text()
    assert int(re.search(rf"constexpr int {const} = (\d+);", src).group(1)) \
        == value


# (k, B, C, T, bt): the path (P = 2176 on the card's machine, 2112 here,
# lists of 88 / 112), ragged and edge shapes, several class chunks.
PLAN_CASES = [(1, 2176, 39, 88, 128), (1, 2112, 39, 112, 128),
              (3, 1001, 100, 400, 32), (1, 1001, 200, 40, 96),
              (2, 1000, 39, 60, 256), (1, 1, 1, 1, 32),
              (1, 33, 128, 2, 64), (4, 6144, 39, 2000, 32)]


@pytest.mark.parametrize("k,B,C,T,bt", PLAN_CASES)
def test_bsp_fwd_launch_plan_mirror(k, B, C, T, bt):
    """K4's blocks are 1, 2, 4 or 8 warps of one tile row: the most that
    still fill every SM once (fewer only where even one warp a block does
    not); the workspace holds K1's partials and the class-padded logP."""
    n_sm = 132
    plan = bsp.fwd_plan(k, B, C, T, bt, n_sm=n_sm)
    rows, groups = plan["rows_per_block"], plan["groups_per_tile_row"]
    pairs = rows // 4
    assert pairs in (1, 2, 4, 8) and groups * rows == bt
    lines = k * -(-B // bt)
    assert pairs == 1 or lines * groups >= n_sm
    assert pairs == 8 or lines * groups // 2 < n_sm
    assert plan["workspace_floats"] == (k * -(-B // 32) * 256
                                        + k * B * -(-C // 4) * 4)
    assert plan["dynamic_smem_bytes"] <= 232_448      # an H100 block's most
    if (k, B, C, bt) == (1, 2176, 39, 128):
        assert (rows, lines * groups) == (16, 136)


@pytest.mark.parametrize("k,B,C,T,bt", PLAN_CASES)
def test_bsp_dlogp_launch_plan_mirror(k, B, C, T, bt):
    """K6's blocks hold an even number of rows of one tile row, 2 a thread
    pair, at most 64 and 512 threads: the most (a multiple of 4) that still
    fill every SM once; the workspace holds the class-padded logP."""
    n_sm = 132
    plan = bsp.dlogp_plan(k, B, C, T, bt, n_sm=n_sm)
    rows, groups = plan["rows_per_block"], plan["groups_per_tile_row"]
    quads = min(-(-C // 4), 32)
    assert rows % 4 == 0 and 4 <= rows <= min(64, bt)
    assert rows // 2 * quads <= 512 and rows // 2 <= 32   # q = 0 in warp 0
    assert (groups - 1) * rows < bt <= groups * rows
    lines = k * -(-C // 128) * -(-B // bt)
    blocks = lines * groups
    assert rows == 4 or blocks >= n_sm
    most = min(2 * (512 // quads), 64, bt) & ~3
    assert rows == most or lines * -(-bt // (rows + 4)) < n_sm
    assert plan["workspace_floats"] == k * B * -(-C // 4) * 4
    assert plan["dynamic_smem_bytes"] <= 232_448
    if (k, B, C, bt) == (1, 2176, 39, 128):
        assert (rows, blocks) == (16, 136)
