"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them; the
file imports neither JAX nor the reference package, so it runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance: the kernels and the plain versions (cuBLAS products) sum float32
terms in different orders; rtol 2e-5 with an atol of 2e-5 of the largest
magnitude.  Repeats must be bit-identical: the kernels use no atomics.  On
a full occupancy mask the block-sparse K4, K5∘K6 and K7 must equal the
dense K1, K2 and K3 bit for bit (the same sums in the same order; K4 and
K6 run K1's and K2's pipelines, at tile edges 64, 128 and 256).  The graph-construction kernels K8 and
K9 hold squared distances to 1e-5·(‖x_i‖² + ‖y_j‖²), the scale of the
float32 round-off of ‖x‖² − 2·x·y + ‖y‖²; K8's indices must equal the
plain version's except at such near ties, and exactly on integer inputs.
The attention kernel K11 is held against its plain version on the same key
tiles (``fa.block_k``: 128 keys on the tensor-core route, bfloat16 at head
dim 64, 112 or 128; 64 on the FMA route) at atol 3e-5 in float32, and in
bfloat16 at |Δ| ≤ 2^-8·max|want| + 2^-7·|want| (both round p and the
output to bfloat16 at the same points; the float32 sums run in other
orders, and the tensor cores take exp from ex2.approx, so a rounding may
fall the other way).  A reduced qwen2 prefill on the card matches the CPU's.
K14 (RMSNorm) is held to its plain version, the float32 composite, by
``kernels.norm.RULE``: only the order of its sum of squares differs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.metabatch import (block_layout,  # noqa: E402
                                        layout_from_occupancy)
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_reg_bsp as bsp  # noqa: E402
from repro_torch.kernels import ops, pairwise, ref  # noqa: E402
from repro_torch.kernels.tuning import TileSpec  # noqa: E402

GAMMA, KAPPA = 0.8, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: run this file on a machine with one")
    return torch.device("cuda")


def _problem(B, C, seed=0, density=0.2):
    rng = np.random.default_rng(seed + 7 * B + C)
    logits = torch.tensor(rng.normal(size=(B, C)) * 2.0, dtype=torch.float32)
    W = np.abs(rng.normal(size=(B, B))) * (rng.random((B, B)) < density)
    return torch.log_softmax(logits, -1), torch.tensor(W, dtype=torch.float32)


def _close(got, want, rtol=2e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", [(2, 200, 8), (2, 200, 39), (2, 257, 70)]
                         + [(k, B, C) for k in (1, 3)
                            for B in (1, 31, 33, 1000, 1001)
                            for C in (1, 39, 100, 128, 200)])
def test_kernels_match_plain_versions(cuda, k, B, C):
    probs = [_problem(B, C, seed=s) for s in range(k)]
    logp = torch.stack([p[0] for p in probs]).to(cuda)
    W = torch.stack([p[1] for p in probs]).to(cuda)
    g = torch.tensor([0.5, -2.0, 0.25][:k], device=cuda)
    gc, kappa, ge = GAMMA, KAPPA, GAMMA
    pairs = [
        (lambda: gr.reg_forward(logp, W, gc, kappa, ge),
         ref.reg_forward_ref(logp, W, gc, kappa, ge)),
        (lambda: gr.reg_bwd_dlogp(logp, W, g, gc, kappa, ge),
         ref.reg_bwd_dlogp_ref(logp, W, g, gc, kappa, ge)),
        (lambda: gr.reg_bwd_dw(logp, g, gc, ge),
         ref.reg_bwd_dw_ref(logp, g, gc, ge)),
    ]
    for kern, want in pairs:
        a, b = kern(), kern()
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _close(a.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_function_on_the_card_matches_cpu(cuda):
    logp, W = _problem(200, 39)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        lp = logp.to(dev).requires_grad_(True)
        w = W.to(dev).requires_grad_(True)
        val = ops.graph_regularizer_fused(lp, w, GAMMA, KAPPA)
        val.backward()
        out[dev.type] = (val.item(), lp.grad.cpu().numpy(),
                         w.grad.cpu().numpy())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want)


@pytest.mark.cuda
def test_training_skips_k3_and_counts_launches(cuda):
    logp, W = _problem(128, 39)
    lp = logp.to(cuda).requires_grad_(True)
    gr.reset_launch_counts()
    ops.graph_regularizer_fused(lp, W.to(cuda), GAMMA, KAPPA).backward()
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    assert counts["graph_reg_fwd"] == counts["graph_reg_bwd_dlogp"] == 1
    assert sum(counts.values()) == 2


@pytest.mark.cuda
def test_pinned_tiles_raise_on_the_card(cuda):
    logp, W = _problem(64, 8)
    with pytest.raises(ValueError, match="fixed block shapes"):
        ops.graph_regularizer_fused(logp.to(cuda), W.to(cuda), 1.0, 0.0,
                                    tiles=TileSpec(bi=64))


def _bsp_problem(B, C, bt, k, seed=0, density=0.4, empty_line=None):
    """k workers of (logp, W, layout): W zero outside a random symmetric
    tile mask, optionally with one empty tile row and column."""
    rng = np.random.default_rng(seed + B + bt)
    nt = -(-B // bt)
    logps, Ws, occs = [], [], []
    for _ in range(k):
        occ = rng.random((nt, nt)) < density
        occ = occ | occ.T
        if empty_line is not None:
            occ[empty_line, :] = occ[:, empty_line] = False
        W = np.abs(rng.normal(size=(B, B))).astype(np.float32)
        mask = np.kron(occ, np.ones((bt, bt), bool))[:B, :B]
        Ws.append(np.where(mask, (W + W.T) / 2, 0.0).astype(np.float32))
        logps.append(torch.log_softmax(torch.tensor(
            rng.normal(size=(B, C)) * 2.0, dtype=torch.float32), -1))
        occs.append(occ)
    T = max(layout_from_occupancy(o, bt).list_len for o in occs)
    lays = [block_layout(W, bt, list_len=T).arrays() for W in Ws]
    arrays = [torch.tensor(np.stack([lay[i] for lay in lays]))
              for i in range(7)]
    return torch.stack(logps), torch.tensor(np.stack(Ws)), arrays


def _bsp_pairs(logp, W, arrays, g, bt, gc, kappa, ge):
    rows, cols, valid, crows, ccols, cvalid, occ = arrays
    bterm = ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid, bt)
    return [
        (lambda: bsp.bsp_forward(logp, W, rows, cols, valid, bt, gc, kappa,
                                 ge),
         ref.bsp_forward_ref(logp, W, rows, cols, valid, bt, gc, kappa, ge)),
        (lambda: bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt), bterm),
        (lambda: bsp.bsp_bwd_dlogp(logp, W, bterm, rows, cols, valid, g, bt,
                                   gc, kappa, ge),
         ref.bsp_bwd_dlogp_ref(logp, W, bterm, rows, cols, valid, g, bt, gc,
                               kappa, ge)),
        (lambda: bsp.bsp_bwd_dw(logp, occ, g, bt, gc, ge),
         ref.bsp_bwd_dw_ref(logp, occ, g, bt, gc, ge)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,bt,empty", [(200, 39, 32, None),
                                          (257, 70, 64, 1),
                                          (300, 39, 128, None),
                                          (1000, 39, 96, 3)])
def test_block_sparse_kernels_match_plain_versions(cuda, B, C, bt, empty):
    logp, W, arrays = _bsp_problem(B, C, bt, k=2, empty_line=empty)
    logp, W = logp.to(cuda), W.to(cuda)
    arrays = [a.to(cuda) for a in arrays]
    g = torch.tensor([0.5, -2.0], device=cuda)
    for kern, want in _bsp_pairs(logp, W, arrays, g, bt, GAMMA, KAPPA,
                                 GAMMA):
        a, b = kern(), kern()
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _close(a.cpu().numpy(), want.cpu().numpy())
    dW = bsp.bsp_bwd_dw(logp, arrays[6], g, bt, GAMMA, GAMMA)
    live = arrays[6].repeat_interleave(bt, -2).repeat_interleave(bt, -1)
    assert bool((dW[live[:, :B, :B] == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", [(1, 2176, 39), (2, 1000, 1),
                                   (2, 1000, 39), (2, 1000, 100),
                                   (1, 1001, 39)])
def test_dw_kernel_matches_plain_version(cuda, k, B, C):
    """The redesigned K3 (64 x 128 tiles, swizzled class-major staging,
    16-byte streaming stores; scalar stores when B % 4 != 0)."""
    logp = torch.stack([_problem(B, C, seed=s)[0] for s in range(k)])
    logp = logp.to(cuda)
    g = torch.tensor([0.5, -2.0][:k], device=cuda)
    a, b = gr.reg_bwd_dw(logp, g, GAMMA, GAMMA), gr.reg_bwd_dw(logp, g,
                                                              GAMMA, GAMMA)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a.cpu().numpy(), ref.reg_bwd_dw_ref(logp, g, GAMMA,
                                               GAMMA).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 64, 128])
@pytest.mark.parametrize("k,B,C", [(2, 1000, 1), (2, 1000, 39),
                                   (2, 1000, 100), (1, 1001, 39),
                                   (1, 2176, 39)])
def test_bterm_kernel_matches_plain_version(cuda, k, B, C, bt):
    """The redesigned K5 (8-row blocks, a cp.async ring; 16-byte copies
    where rows allow, 4-byte copies otherwise)."""
    logp, W, arrays = _bsp_problem(B, C, bt, k=k, density=0.25,
                                   empty_line=1)
    logp, W = logp.to(cuda), W.to(cuda)
    crows, ccols, cvalid = (a.to(cuda) for a in arrays[3:6])
    a = bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt)
    b = bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a.cpu().numpy(), ref.bsp_bwd_bterm_ref(
        logp, W, crows, ccols, cvalid, bt).cpu().numpy())


@pytest.mark.cuda
def test_bterm_kernel_takes_a_long_list(cuda):
    """K5 on a full mask at bt = 32 and C = 128 (the widest class chunk):
    a 36,864-entry list whose strips hold 192 tiles each.  Its shared
    memory holds one strip's tiles, not the whole list, so it stays
    under the card's 227 KB."""
    B, C, bt = 6144, 128, 32
    logp, W, arrays = _bsp_problem(B, C, bt, k=1, density=2.0)
    logp, W = logp.to(cuda), W.to(cuda)
    crows, ccols, cvalid = (a.to(cuda) for a in arrays[3:6])
    T = crows.shape[-1]
    assert T >= (B // bt) ** 2
    assert bsp.bterm_smem_bytes(B, C, T, bt) <= 227 * 1024
    a = bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt)
    b = bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a.cpu().numpy(), ref.bsp_bwd_bterm_ref(
        logp, W, crows, ccols, cvalid, bt).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [64, 128, 256])
def test_block_sparse_full_mask_equals_dense_kernels(cuda, bt):
    """Full mask: K4 is K1, K5∘K6 is K2 and K7 is K3, bit for bit (the
    same sums in the same order, the same epilogues)."""
    logp, W, arrays = _bsp_problem(256, 39, bt, k=2, density=2.0)
    logp, W = logp.to(cuda), W.to(cuda)
    rows, cols, valid, crows, ccols, cvalid, occ = [a.to(cuda)
                                                    for a in arrays]
    assert bool(occ.all())
    g = torch.tensor([0.5, -2.0], device=cuda)
    assert torch.equal(bsp.bsp_forward(logp, W, rows, cols, valid, bt, GAMMA,
                                       KAPPA, GAMMA),
                       gr.reg_forward(logp, W, GAMMA, KAPPA, GAMMA))
    bterm = bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt)
    assert torch.equal(bsp.bsp_bwd_dlogp(logp, W, bterm, rows, cols, valid,
                                         g, bt, GAMMA, KAPPA, GAMMA),
                       gr.reg_bwd_dlogp(logp, W, g, GAMMA, KAPPA, GAMMA))
    assert torch.equal(bsp.bsp_bwd_dw(logp, occ, g, bt, GAMMA, GAMMA),
                       gr.reg_bwd_dw(logp, g, GAMMA, GAMMA))


#: Tile masks of the redesigned K4's and K6's cases (as chip_smoke.py's).
MASK_KINDS = ("empty tile row", "one full tile row", "tail-padded", "full")


def _bsp_case(k, B, C, bt, kind, seed=0):
    """k workers of (logp, W, layout) under a tile mask of ``kind``: one
    tile row empty, one tile row holding every tile (and nothing else), a
    random mask with lists padded past the longest worker's, or every
    tile occupied."""
    rng = np.random.default_rng(seed + B + C + bt)
    nt = -(-B // bt)
    Ws = []
    for _ in range(k):
        if kind == "one full tile row":
            occ = np.zeros((nt, nt), bool)
            occ[nt // 2] = True
        else:
            occ = rng.random((nt, nt)) < (2.0 if kind == "full" else 0.3)
            if kind == "empty tile row":
                occ[min(1, nt - 1)] = False
        mask = np.kron(occ, np.ones((bt, bt), bool))[:B, :B]
        W = np.abs(rng.normal(size=(B, B))).astype(np.float32)
        Ws.append(np.where(mask, W, 0.0).astype(np.float32))
    T = max(block_layout(W, bt).list_len for W in Ws)
    T += 7 if kind == "tail-padded" else 0
    lays = [block_layout(W, bt, list_len=T).arrays() for W in Ws]
    arrays = [torch.tensor(np.stack([lay[i] for lay in lays]))
              for i in range(7)]
    logp = torch.log_softmax(torch.tensor(
        rng.normal(size=(k, B, C)) * 2.0, dtype=torch.float32), -1)
    return logp, torch.tensor(np.stack(Ws)), arrays


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 64, 128, 256])
@pytest.mark.parametrize("B", [1, 31, 33, 1000, 1001])
def test_redesigned_k4_and_k6_match_plain_versions(cuda, B, bt):
    """K4 on K1's pipeline and K6 on K2's, over the listed tiles: k 1 and
    3, C 1 to 200 (two of K6's class chunks, four of K4's), every mask
    kind; repeats bit-identical."""
    for k in (1, 3):
        g = torch.tensor([0.5, -2.0, 0.25][:k], device=cuda)
        for C in (1, 39, 100, 128, 200):
            for kind in MASK_KINDS:
                logp, W, arrays = _bsp_case(k, B, C, bt, kind)
                logp, W = logp.to(cuda), W.to(cuda)
                rows, cols, valid, crows, ccols, cvalid, _ = [
                    a.to(cuda) for a in arrays]
                bterm = ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid,
                                              bt)
                for kern, plain in (
                        (lambda: bsp.bsp_forward(logp, W, rows, cols, valid,
                                                 bt, GAMMA, KAPPA, GAMMA),
                         lambda: ref.bsp_forward_ref(logp, W, rows, cols,
                                                     valid, bt, GAMMA, KAPPA,
                                                     GAMMA)),
                        (lambda: bsp.bsp_bwd_dlogp(
                            logp, W, bterm, rows, cols, valid, g, bt, GAMMA,
                            KAPPA, GAMMA),
                         lambda: ref.bsp_bwd_dlogp_ref(
                            logp, W, bterm, rows, cols, valid, g, bt, GAMMA,
                            KAPPA, GAMMA))):
                    a, b = kern(), kern()
                    torch.cuda.synchronize()
                    assert torch.equal(a, b), (k, C, kind)
                    _close(a.cpu().numpy(), plain().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("B", [1, 33, 130, 1000, 1001])
def test_redesigned_k7_matches_plain_version_and_k3(cuda, B, bt):
    """K7 on K3's tile (dw_tile): k 1 and 3, C 1 to 200 (K3's class chunks
    of 40), every mask kind, B not a multiple of 4 (scalar stores) and
    pieces spanning several tiles (bt < 128); exact zeros off the occupied
    tiles, repeats bit-identical, and K3's bits on a full mask.  gc != ge:
    at B = 1 the single entry is -g·h·(ge - gc), zero when they are equal,
    and no tolerance relative to the output holds that."""
    for k in (1, 3):
        g = torch.tensor([0.5, -2.0, 0.25][:k], device=cuda)
        for C in (1, 39, 200):
            for kind in MASK_KINDS:
                logp, _, arrays = _bsp_case(k, B, C, bt, kind)
                logp, occ = logp.to(cuda), arrays[6].to(cuda)
                a = bsp.bsp_bwd_dw(logp, occ, g, bt, GAMMA, 0.5)
                b = bsp.bsp_bwd_dw(logp, occ, g, bt, GAMMA, 0.5)
                torch.cuda.synchronize()
                assert torch.equal(a, b), (k, C, kind)
                live = occ.repeat_interleave(bt, -2).repeat_interleave(
                    bt, -1)[:, :B, :B]
                assert bool((a[live == 0] == 0).all()), (k, C, kind)
                _close(a.cpu().numpy(), ref.bsp_bwd_dw_ref(
                    logp, occ, g, bt, GAMMA, 0.5).cpu().numpy())
                if kind == "full":
                    assert torch.equal(a, gr.reg_bwd_dw(logp, g, GAMMA, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 1001])
def test_k7_writes_an_unaligned_output(cuda, B):
    """The library's K7 into a view one float past an aligned buffer: the
    16-byte stores need an aligned dW, so it must take the scalar stores
    and write what the wrapper's own output holds."""
    bt = 64
    logp, _, arrays = _bsp_case(2, B, 39, bt, "tail-padded")
    logp, occ = logp.to(cuda), arrays[6].to(cuda)
    p = torch.exp(logp)
    g = torch.tensor([0.5, -2.0], device=cuda)
    buf = torch.full((2 * B * B + 2,), float("nan"), device=cuda)
    view = buf[1:-1].view(2, B, B)
    rc = bsp._lib().graph_reg_bsp_dw(
        p.data_ptr(), logp.data_ptr(), occ.data_ptr(), g.data_ptr(), 2, B,
        39, bt, GAMMA, 0.5, view.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(view, bsp.bsp_bwd_dw(logp, occ, g, bt, GAMMA, 0.5))
    assert bool(buf[0].isnan()) and bool(buf[-1].isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C,T,bt", [(1, 2176, 39, 88, 128),
                                        (3, 1001, 100, 400, 32),
                                        (1, 1001, 200, 40, 96),
                                        (2, 1000, 39, 60, 256),
                                        (1, 1, 1, 1, 32)])
def test_bsp_launch_plans_match_their_mirrors(cuda, k, B, C, T, bt):
    """The library's K4 and K6 plans on this card equal the Python
    mirrors that the CPU tests hold to the source."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name, mirror in (("graph_reg_bsp_fwd", bsp.fwd_plan),
                         ("graph_reg_bsp_dlogp", bsp.dlogp_plan)):
        want = mirror(k, B, C, T, bt, n_sm=n_sm)
        assert bsp.launch_plan(name, k, B, C, T, bt) == {
            key: want[key] for key in ("rows_per_block",
                                       "dynamic_smem_bytes")}
        assert getattr(bsp._lib(), f"{name}_workspace")(k, B, C) == \
            want["workspace_floats"]


@pytest.mark.cuda
def test_block_sparse_function_on_the_card_matches_cpu(cuda):
    logp, W, arrays = _bsp_problem(300, 39, 64, k=2, empty_line=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        lp = logp.to(dev).requires_grad_(True)
        w = W.to(dev).requires_grad_(True)
        val = ops.graph_regularizer_blocksparse(
            lp, w, GAMMA, KAPPA, layout=[a.to(dev) for a in arrays],
            tiles=TileSpec(bi=64))
        val.sum().backward()
        out[dev.type] = (val.detach().cpu().numpy(), lp.grad.cpu().numpy(),
                         w.grad.cpu().numpy())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want)


@pytest.mark.cuda
def test_block_sparse_training_skips_k7_and_counts_launches(cuda):
    logp, W, arrays = _bsp_problem(256, 39, 64, k=1)
    lp = logp.to(cuda).requires_grad_(True)
    gr.reset_launch_counts()
    ops.graph_regularizer_auto(lp, W.to(cuda), GAMMA, KAPPA,
                               layout=[a.to(cuda) for a in arrays],
                               tiles=TileSpec(bi=64)).sum().backward()
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    assert counts == {**{name: 0 for name in counts},
                      "graph_reg_bsp_fwd": 1, "graph_reg_bsp_bterm": 1,
                      "graph_reg_bsp_dlogp": 1}


@pytest.mark.cuda
def test_block_sparse_refusals_on_the_card(cuda):
    logp, W, arrays = _bsp_problem(192, 8, 48, k=1)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.graph_regularizer_blocksparse(
            logp.to(cuda), W.to(cuda), 1.0, 0.0,
            layout=[a.to(cuda) for a in arrays], tiles=TileSpec(bi=48))
    logp, W, arrays = _bsp_problem(192, 8, 64, k=1)
    with pytest.raises(ValueError, match="fixed block shapes"):
        ops.graph_regularizer_blocksparse(
            logp.to(cuda), W.to(cuda), 1.0, 0.0,
            layout=[a.to(cuda) for a in arrays], tiles=TileSpec(bi=64, bc=8))


D2_RTOL = 1e-5


def _knn_inputs(N, M, D, seed=0, integer=False):
    """y (M, D) and x = its first N rows (so exclude_self means the same
    row); integer-valued rows with duplicates give exact ties."""
    rng = np.random.default_rng(seed + N + M + D)
    if integer:
        y = rng.integers(0, 3, size=(M, D)).astype(np.float32)
        y[M // 2:M // 2 + N // 4] = y[:N // 4]
    else:
        y = rng.normal(size=(M, D)).astype(np.float32)
    y = torch.tensor(y)
    return y[:N].contiguous(), y


def _check_knn(x, y, k, got, want):
    """d2 within D2_RTOL of the scale; an index may differ only where the
    two candidates' plain d2 are that close (a near tie)."""
    (d2, idx), (pd, pi) = got, want
    nx, ny = (x * x).sum(1), (y * y).sum(1)
    scale = nx[:, None] + torch.maximum(ny[idx.long()], ny[pi.long()])
    assert bool(((d2 - pd).abs() <= D2_RTOL * scale).all())
    r, c = (idx != pi).nonzero(as_tuple=True)
    full = ref._sq_dists(x, y)
    alt = full[r, idx[r, c].long()]
    assert bool(((alt - pd[r, c]).abs() <= D2_RTOL * scale[r, c]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D,k,ex", [(40, 40, 16, 5, True),
                                        (130, 257, 100, 10, False),
                                        (33, 65, 7, 3, False),
                                        (300, 700, 64, 32, True),
                                        (1000, 1000, 351, 10, True),
                                        (300, 700, 64, 40, True),
                                        (130, 600, 32, 256, False),
                                        (257, 257, 16, 256, True),
                                        (600, 600, 32, 300, True),
                                        (200, 1100, 16, 1000, False),
                                        # the packing's feature padding
                                        (257, 300, 1, 12, True),
                                        (130, 200, 3, 7, False),
                                        # column segments (33 tiles, 7
                                        # segments on 132 SMs)
                                        (300, 4100, 351, 10, True),
                                        (500, 4100, 8, 300, True),
                                        # either side of K_MAX
                                        (200, 300, 16, 120, False),
                                        (200, 300, 16, 121, False),
                                        (190, 190, 5, 32, True),
                                        (190, 190, 5, 33, True)])
def test_knn_topk_matches_plain_version(cuda, N, M, D, k, ex):
    x, y = (t.to(cuda) for t in _knn_inputs(N, M, D))
    before = pairwise.knn_topk.launches
    a = pairwise.knn_topk(x, y, k, exclude_self=ex)
    b = ops.knn_topk(x, y, k, exclude_self=ex)
    torch.cuda.synchronize()
    assert pairwise.knn_topk.launches == before + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.int32
    _check_knn(x, y, k, a, ref.knn_topk_ref(x, y, k, exclude_self=ex))
    if ex:
        rows = torch.arange(N, device=cuda)[:, None]
        assert not bool((a[1] == rows).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 40, 299])
@pytest.mark.parametrize("ex", [False, True])
def test_knn_topk_exact_ties_go_to_the_lowest_index(cuda, ex, k):
    x, y = (t.to(cuda) for t in _knn_inputs(150, 300, 4, integer=True))
    d2, idx = pairwise.knn_topk(x, y, k, exclude_self=ex)
    pd, pi = ref.knn_topk_ref(x, y, k, exclude_self=ex)
    assert torch.equal(d2, pd) and torch.equal(idx, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [11, 40, 200])
@pytest.mark.parametrize("ex", [False, True])
def test_knn_topk_exact_ties_across_segments(cuda, ex, k):
    """Integer rows with 81 distinct values and duplicates half the corpus
    apart: exact ties within every column segment and across each of their
    boundaries (33 tiles in 7 segments on 132 SMs); the lists must be the
    plain version's exactly."""
    x, y = (t.to(cuda) for t in _knn_inputs(300, 4100, 4, integer=True))
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pairwise.launch_plan("knn_topk", 300, 4100, 4, k,
                                same=False)["segments"] > 1 or n_sm < 8
    d2, idx = pairwise.knn_topk(x, y, k, exclude_self=ex)
    pd, pi = ref.knn_topk_ref(x, y, k, exclude_self=ex)
    assert torch.equal(d2, pd) and torch.equal(idx, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 150])
def test_knn_topk_exclude_self_with_more_queries_than_candidates(cuda, k):
    """N > M with exclude_self: rows i < M skip column i, the others skip
    nothing."""
    x = torch.randn(700, 24, device=cuda)
    y = x[:300]
    got = pairwise.knn_topk(x, y, k, exclude_self=True)
    want = ref.knn_topk_ref(x, y, k, exclude_self=True)
    _check_knn(x, y, k, got, want)
    rows = torch.arange(300, device=cuda)[:, None]
    assert not bool((got[1][:300] == rows).any())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 351])
def test_pairwise_kernels_take_offset_views(cuda, D):
    """x and y as views that start one row into their storage (rows of
    12 or 1,404 bytes: not 16-byte aligned): the packing reads them as
    they lie."""
    base = torch.randn(1 + 600, D, device=cuda)
    y = base[1:]
    x = y[:250]
    assert x.data_ptr() % 16 != 0
    got = pairwise.knn_topk(x, y, 10, exclude_self=True)
    _check_knn(x, y, 10, got, ref.knn_topk_ref(x, y, 10, exclude_self=True))
    w = pairwise.rbf_affinity(x, y, 1.5)
    want = ref.rbf_affinity_ref(x, y, 1.5)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    tol = 2e-5 + want * torch.sqrt(D2_RTOL * scale) / (2 * 1.5 * 1.5)
    assert bool(((w - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D,k,same", [(20000, 20000, 351, 10, True),
                                          (2000, 2000, 351, 1000, True),
                                          (300, 4100, 4, 40, False),
                                          (33, 65, 7, 3, False)])
def test_launch_plans_match_their_mirrors(cuda, N, M, D, k, same):
    """The library's K8 and K9 plans on this card equal the Python mirrors
    that the CPU tests hold to the source."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = pairwise.knn_plan(N, M, D, k, same=same, n_sm=n_sm)
    del want["seg_tiles"]
    assert pairwise.launch_plan("knn_topk", N, M, D, k, same=same) == want
    assert pairwise.launch_plan("rbf_affinity", N, M, D, same=same) == \
        pairwise.rbf_plan(N, M, D, same=same, n_sm=n_sm)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D", [(32, 32, 16), (64, 64, 351),
                                   (130, 70, 64), (33, 257, 100),
                                   (128, 128, 256), (100, 90, 1),
                                   (200, 130, 3), (2176, 2176, 351),
                                   (2048, 2048, 16)])
def test_rbf_affinity_matches_plain_version(cuda, N, M, D):
    rng = np.random.default_rng(N + M + D)
    x = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32).to(cuda)
    y = torch.tensor(rng.normal(size=(M, D)), dtype=torch.float32).to(cuda)
    sigma = 2.0
    a, b = pairwise.rbf_affinity(x, y, sigma), ops.rbf_affinity(x, y, sigma)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = ref.rbf_affinity_ref(x, y, sigma)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    tol = 2e-5 + want * torch.sqrt(D2_RTOL * scale) / (2 * sigma * sigma)
    assert bool(((a - want).abs() <= tol).all())


#: K1's plans: the paper's shapes (row plan), every LM head and ragged
#: wide-C shapes (class-split plan: B 1 to 200, C odd or not a multiple of
#: 4, one to 2 × 2 and 4 × 4 row tiles, k 1 to 3).
K1_PLAN_SHAPES = [(1, 2176, 39), (4, 2176, 39), (3, 1001, 100),
                  (1, 1001, 200), (1, 16, 151936), (2, 16, 151936),
                  (1, 17, 32000), (1, 16, 32000), (1, 16, 50304),
                  (1, 16, 50257), (1, 4, 512), (1, 1, 300), (1, 5, 1001), (2, 33, 777),
                  (1, 65, 3000), (3, 17, 2049), (1, 200, 20000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", K1_PLAN_SHAPES)
def test_k1_launch_plan_matches_its_mirror(cuda, k, B, C):
    """The library's K1 plan and workspace are ``gr.fwd_plan``'s on this
    card: the row plan at the paper's shapes, the class-split plan at
    narrow B and wide C."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gr.fwd_plan(k, B, C, n_sm=n_sm)
    assert gr.launch_plan("graph_reg_fwd", k, B, C) == {
        key: plan[key] for key in ("rows_per_block", "dynamic_smem_bytes",
                                   "class_chunk", "blocks")}
    assert gr._lib().graph_reg_fwd_workspace(k, B, C) == \
        plan["workspace_floats"]


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", [s for s in K1_PLAN_SHAPES
                                   if s[1] <= 200 and s[2] > 256])
def test_class_split_k1_holds_float64_and_equals_k10(cuda, k, B, C):
    """K1 on the class-split plan at the LM heads and ragged wide shapes:
    repeated bit for bit, held to float64 within 4·√C·2^-24·M (M = γ·Σ
    W·Hc + Σ (κ + γ·deg)·H, chip_smoke.K1_LM_RULE) as its plain version
    is, and with n, the plan's longest chain, for C (K1_CS_RULE); K10
    equal to K1 at (1, 0, 0) on the same (1, B, C) bit for bit (the plan,
    and with it the sum order, depends on k)."""
    probs = [_problem(B, C, seed=s, density=0.5) for s in range(k)]
    logp = torch.stack([p[0] for p in probs]).to(cuda)
    W = torch.stack([p[1] for p in probs]).to(cuda)
    W = W + W.mT
    gamma, kappa = 0.05, 1e-4
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gr.fwd_plan(k, B, C, n_sm=n_sm)
    assert plan["route"] == "classes"
    a = gr.reg_forward(logp, W, gamma, kappa, gamma)
    b = gr.reg_forward(logp, W, gamma, kappa, gamma)
    plain = ref.reg_forward_ref(logp, W, gamma, kappa, gamma)
    cross = torch.cat([gr.reg_forward(logp[z:z + 1], W[z:z + 1], 1.0, 0.0,
                                      0.0) for z in range(k)])
    k10 = torch.stack([gr.reg_pairwise(logp[z], W[z]) for z in range(k)])
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(k10, cross)
    lp64, W64 = logp.double(), W.double()
    want64 = ref.reg_forward_ref(lp64, W64, gamma, kappa, gamma)
    M = ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma)
    tol = 4.0 * C ** 0.5 * 2.0 ** -24 * float(M.abs().max())
    for value in (a, plain):
        assert float((value.double() - want64).abs().max()) <= tol
    n = gr.class_split_chain(B, plan)
    assert float((a.double() - want64).abs().max()) <= \
        4.0 * n ** 0.5 * 2.0 ** -24 * float(M.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", K1_PLAN_SHAPES)
def test_k2_launch_plan_matches_its_mirror(cuda, k, B, C):
    """The library's K2 plan and workspace are ``gr.dlogp_plan``'s on this
    card: the row route at the paper's shapes and past 64 rows, the class
    route (no workspace) at narrow B and wide C."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gr.dlogp_plan(k, B, C, n_sm=n_sm)
    got = gr.launch_plan("graph_reg_bwd_dlogp", k, B, C)
    assert got == {key: plan[key] for key in got}
    assert (got["class_span"] > 0) == (plan["route"] == "classes")
    assert gr._lib().graph_reg_bwd_dlogp_workspace(k, B, C) == \
        plan["workspace_floats"]


#: K2's class route: every narrow shape of K1's plans (the LM heads, B 1
#: to 33, C ragged or not a multiple of 4, k 1 to 3).
K2_CLASS_SHAPES = [s for s in K1_PLAN_SHAPES
                   if gr.dlogp_route(s[1], s[2]) == "classes"]


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", K2_CLASS_SHAPES)
def test_k2_class_route_repeats_and_matches_plain_version(cuda, k, B, C):
    """K2 on its class route: repeated bit for bit, and within the usual
    rule (rtol 2e-5, tighter than the LM path's 1e-4) of its plain
    version, at the LM heads and at ragged narrow shapes (B 5, 17, 33; C
    777, 1001, 2049: 4-byte copies), with a cotangent of either sign per
    worker."""
    probs = [_problem(B, C, seed=s, density=0.5) for s in range(k)]
    logp = torch.stack([p[0] for p in probs]).to(cuda)
    W = torch.stack([p[1] for p in probs]).to(cuda)
    W = W + W.mT
    g = torch.tensor([0.5, -2.0, 0.25][:k], device=cuda)
    gamma, kappa = 0.05, 1e-4
    before = gr.reg_bwd_dlogp.launches
    a = gr.reg_bwd_dlogp(logp, W, g, gamma, kappa, gamma)
    b = gr.reg_bwd_dlogp(logp, W, g, gamma, kappa, gamma)
    want = ref.reg_bwd_dlogp_ref(logp, W, g, gamma, kappa, gamma)
    torch.cuda.synchronize()
    assert gr.reg_bwd_dlogp.launches == before + 2
    assert torch.equal(a, b)
    _close(a.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", [(1, 16, 4096), (2, 17, 1000)])
def test_k2_class_route_takes_unaligned_inputs(cuda, k, B, C):
    """P and logP one float past a 16-byte boundary (C a multiple of 4):
    the class route falls back to 4-byte copies and scalar stores and
    gives the aligned call's bits."""
    logp, W = _problem(B, C, seed=k, density=0.5)
    logp = logp.expand(k, B, C).contiguous().to(cuda)
    W = (W + W.T).expand(k, B, B).contiguous().to(cuda)
    g = torch.tensor([1.0 / B, -0.5][:k], device=cuda)
    p = torch.exp(logp)
    buf = torch.empty(2, 1 + k * B * C, device=cuda)
    lp_off = buf[0, 1:].view(k, B, C)
    p_off = buf[1, 1:].view(k, B, C)
    lp_off.copy_(logp)
    p_off.copy_(p)
    assert lp_off.data_ptr() % 16 != 0
    a = gr.reg_bwd_dlogp(logp, W, g, 0.05, 1e-4, 0.05, p=p)
    b = gr.reg_bwd_dlogp(lp_off, W, g, 0.05, 1e-4, 0.05, p=p_off)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(200, 8), (257, 39), (1000, 39),
                                 (1001, 39)])
def test_pairwise_cross_term_matches_plain_version_and_k1(cuda, B, C):
    logp, W = _problem(B, C)
    logp, W = logp.to(cuda), W.to(cuda)
    a, b = gr.reg_pairwise(logp, W), gr.reg_pairwise(logp, W)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a.cpu().numpy(), ref.graph_reg_pairwise_ref(logp, W).cpu().numpy())
    k1 = gr.reg_forward(logp[None], W[None], 1.0, 0.0, 0.0)[0]
    assert torch.equal(a, k1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        lp = logp.detach().to(dev).clone().requires_grad_(True)
        w = W.detach().to(dev).clone().requires_grad_(True)
        val = ops.graph_reg_pairwise(lp, w)
        val.backward()
        out[dev.type] = (val.item(), lp.grad.cpu().numpy(),
                         w.grad.cpu().numpy())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want)


@pytest.mark.cuda
def test_graph_construction_kernels_refuse_pinned_tiles(cuda):
    x = torch.randn(64, 8, device=cuda)
    with pytest.raises(ValueError, match="fixed block shapes"):
        pairwise.knn_topk(x, x, 3, tiles=TileSpec(bi=32))
    with pytest.raises(ValueError, match="fixed block shapes"):
        pairwise.rbf_affinity(x, x, 1.0, tiles=TileSpec(bd=16))
    logp, W = _problem(64, 8)
    with pytest.raises(ValueError, match="fixed block shapes"):
        ops.graph_reg_pairwise(logp.to(cuda), W.to(cuda),
                               tiles=TileSpec(bi=64))
    # k = M with exclude_self leaves M - 1 candidates: refused, as on the
    # CPU.
    with pytest.raises(ValueError, match="k must be in"):
        pairwise.knn_topk(x, x, 64, exclude_self=True)
    # Past K_MAX the lists live in global memory (the global route): the
    # plain version's lists, bits repeated.
    big = torch.randn(pairwise.K_MAX + 2, 8, device=cuda)
    k = pairwise.K_MAX + 1
    assert pairwise.route(k) == "global"
    a, b = pairwise.knn_topk(big, big, k), pairwise.knn_topk(big, big, k)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _check_knn(big, big, k, a, ref.knn_topk_ref(big, big, k))


def _attn_inputs(B, Tq, H, KV, hd, Tk=None, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed + Tq + hd)
    Tk = Tq if Tk is None else Tk
    return [torch.tensor(rng.normal(size=shape), dtype=torch.float32)
            .to(dtype) for shape in ((B, Tq, H, hd), (B, Tk, KV, hd),
                                     (B, Tk, KV, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal",
                         [(2, 64, 64, 4, 2, 32, True),
                          (1, 100, 100, 4, 4, 16, True),
                          (2, 48, 48, 8, 2, 64, True),
                          (1, 130, 130, 12, 2, 128, True),
                          (1, 40, 100, 12, 2, 128, True),
                          (2, 100, 100, 8, 2, 64, False),
                          (1, 1000, 1000, 12, 2, 128, True),
                          (1, 512, 2048, 12, 2, 128, True),
                          (1, 40, 100, 8, 2, 64, True),
                          (1, 1000, 1000, 8, 1, 64, True),
                          (2, 130, 300, 12, 2, 128, False),
                          (12, 256, 256, 12, 2, 128, True),
                          (2, 200, 200, 8, 1, 112, True),
                          (1, 40, 130, 16, 2, 112, True),
                          (1, 100, 300, 8, 2, 112, False),
                          (2, 130, 130, 4, 4, 64, True),
                          (1, 70, 200, 6, 2, 128, True),
                          (1, 300, 300, 6, 2, 128, False)])
def test_flash_attention_matches_plain_version(cuda, dtype, B, Tq, Tk, H,
                                               KV, hd, causal):
    """bfloat16 at hd 64, 112 (kimi-k2's, in the tile of hd 128) and 128
    runs the tensor-core route: ragged Tq = Tk (130, 200, 1000), Tq < Tk
    (40 against 100 or 130; 512 against 2048, the kernel phase's case),
    non-causal with a ragged Tk, B·H = 144 (more blocks a query row
    than the card's 132 SMs), and the groups of qwen1.5-0.5b and
    musicgen-large (H/KV 1 at hd 64) and phi4-mini-3.8b (3 at hd 128);
    float32 runs the FMA route at every head dim."""
    q, k, v = (t.to(cuda) for t in _attn_inputs(B, Tq, H, KV, hd, Tk, dtype))
    a = fa.flash_attention_gqa(q, k, v, causal=causal)
    b = fa.flash_attention_gqa(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   block_k=fa.block_k(dtype, hd))
    torch.cuda.synchronize()
    assert a.dtype == dtype and a.shape == q.shape
    assert torch.equal(a, b)
    got, want = a.float(), want.float()
    if dtype == torch.float32:
        tol = torch.full_like(want, 3e-5)
    else:
        tol = 2.0 ** -8 * want.abs().max() + 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
def test_flash_attention_routes(cuda):
    """The serve paths' shapes (bf16, hd 64, 112 and 128) take the tensor
    cores; each route's launch counts once and gives the same bits
    twice."""
    for hd in (64, 112, 128):
        assert fa.route(torch.bfloat16, hd) == "wgmma"
        assert fa.block_k(torch.bfloat16, hd) == 128
    for dtype, hd in ((torch.bfloat16, 128), (torch.bfloat16, 64),
                      (torch.bfloat16, 32), (torch.float32, 128),
                      (torch.bfloat16, 112), (torch.float32, 112)):
        q, k, v = (t.to(cuda) for t in _attn_inputs(1, 200, 4, 2, hd,
                                                    dtype=dtype))
        gr.reset_launch_counts()
        a = fa.flash_attention_gqa(q, k, v)
        assert gr.launch_counts()["flash_attention"] == 1
        assert torch.equal(a, fa.flash_attention_gqa(q, k, v))


@pytest.mark.cuda
def test_flash_attention_refuses_a_misaligned_view(cuda):
    """The tensor-core route loads through the TMA: a view that starts off
    a 16-byte boundary raises instead of launching (or falling back)."""
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 64, 4, 2, 128,
                                                dtype=torch.bfloat16))
    flat = torch.empty(k.numel() + 8, dtype=k.dtype, device=cuda)
    k_off = flat[1:1 + k.numel()].view(k.shape).copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16
    gr.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_gqa(q, k_off, v)
    assert gr.launch_counts()["flash_attention"] == 0
    # The FMA route reads element by element and takes the same view.
    f32 = [t.float() for t in (q, k, v)]
    k_f32 = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    k_f32.copy_(f32[1])
    torch.testing.assert_close(fa.flash_attention_gqa(f32[0], k_f32, f32[2]),
                               fa.flash_attention_gqa(*f32), rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_refusals_and_counts_on_the_card(cuda):
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_gqa(q[..., :24].contiguous(),
                               k[..., :24].contiguous(),
                               v[..., :24].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_gqa(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_gqa(q, k.cpu(), v)
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.flash_attention_gqa(q.requires_grad_(True), k, v)
    gr.reset_launch_counts()
    ops.flash_attention_gqa(q.detach(), k, v)
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    assert counts == {**{name: 0 for name in counts}, "flash_attention": 1}


@pytest.mark.cuda
def test_resolve_device_pins_bf16_reduction_off(cuda):
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


@pytest.mark.cuda
def test_reduced_prefill_on_the_card_matches_cpu(cuda):
    """qwen2-1.5b reduced (f32): prefill logits and cache on the card
    against the CPU path from the same params, K11 once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    resolve_device("cuda")
    cfg = get_config("qwen2-1.5b").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(1))
    out_cpu, cache_cpu = tf.prefill(params, cfg, toks, cache_len=104)
    gr.reset_launch_counts()
    out, cache = tf.prefill(to_torch(params, cuda), cfg, toks.to(cuda),
                            cache_len=104)
    torch.cuda.synchronize()
    assert gr.launch_counts()["flash_attention"] == cfg.n_layers
    np.testing.assert_allclose(out["logits"].cpu().numpy(),
                               out_cpu["logits"].numpy(), atol=1e-4)
    for f in ("k", "v"):
        np.testing.assert_allclose(
            getattr(cache["layers"][0], f).cpu().numpy(),
            getattr(cache_cpu["layers"][0], f).numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,C", [(1, 16, 151936), (2, 16, 151936),
                                   (1, 17, 32000)])
def test_regularizer_kernels_at_the_lm_heads_shapes(cuda, k, B, C):
    """K1 and K2 at the LM training path's shapes (B sequences of one SSL
    group, C the vocabulary), with the example's γ = 0.05, κ = 1e-4.  K1
    sums C float32 products a pair of rows in one fixed-order chain each,
    and its L is a difference of two positive sums far larger than L: K1
    and its plain version are held to the float64 value within 4·√C·2^-24
    of M = γ·Σ W·Hc + Σ (κ + γ·deg)·H, the sum of the magnitudes (the
    round-off of a C-term chain grows as √C·u).  K2 sums over B only: the
    usual rule."""
    probs = [_problem(B, C, seed=s, density=0.5) for s in range(k)]
    logp = torch.stack([p[0] for p in probs]).to(cuda)
    W = torch.stack([p[1] for p in probs]).to(cuda)
    W = W + W.mT
    g = torch.full((k,), 1.0 / B, device=cuda)
    gamma, kappa = 0.05, 1e-4
    got = [gr.reg_forward(logp, W, gamma, kappa, gamma),
           gr.reg_bwd_dlogp(logp, W, g, gamma, kappa, gamma)]
    again = [gr.reg_forward(logp, W, gamma, kappa, gamma),
             gr.reg_bwd_dlogp(logp, W, g, gamma, kappa, gamma)]
    want = [ref.reg_forward_ref(logp, W, gamma, kappa, gamma),
            ref.reg_bwd_dlogp_ref(logp, W, g, gamma, kappa, gamma)]
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    lp64, W64 = logp.double(), W.double()
    want64 = ref.reg_forward_ref(lp64, W64, gamma, kappa, gamma)
    M = ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma)
    tol = 4.0 * C ** 0.5 * 2.0 ** -24 * float(M.abs().max())
    for value in (got[0], want[0]):
        assert float((value.double() - want64).abs().max()) <= tol
    _close(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
def test_full_width_lm_loss_on_the_card_matches_cpu(cuda):
    """qwen2-1.5b at full width, 2 layers, float32: one ``lm_loss`` forward
    and backward with the SSL term (K1 and K2 once each) on the card
    against the CPU's plain path, from the same params and batch: metrics
    within rtol 1e-4, each gradient leaf within 1e-3 of its largest
    |value|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.core.ssl_loss import SSLHyper, tree_leaves
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import lm_grads
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (8, 33))
    W = rng.random((1, 8, 8)) * (rng.random((1, 8, 8)) < 0.5)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "W": torch.tensor(W + W.transpose(0, 2, 1), dtype=torch.float32),
             "seq_labels": torch.from_numpy(
                 rng.integers(0, 8, (1, 8)).astype(np.int32)),
             "seq_label_mask": torch.tensor([[1.0, 0, 0, 1, 0, 0, 0, 0]])}
    hyper = SSLHyper(gamma=0.05, kappa=1e-4, weight_decay=0.0)
    g_cpu, m_cpu = lm_grads(params, batch, cfg=cfg, hyper=hyper,
                            pairwise="auto")
    gr.reset_launch_counts()
    g_gpu, m_gpu = lm_grads(to_torch(params, cuda),
                            {k: v.to(cuda) for k, v in batch.items()},
                            cfg=cfg, hyper=hyper, pairwise="auto")
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    assert counts == {**{n: 0 for n in counts}, "graph_reg_fwd": 1,
                      "graph_reg_bwd_dlogp": 1}
    for key, want in m_cpu.items():
        np.testing.assert_allclose(float(m_gpu[key]), float(want),
                                   rtol=1e-4, atol=1e-4 * max(
                                       1.0, abs(float(want))))
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max()))


@pytest.mark.cuda
def test_prefill_spans_hold_to_the_profilers_clock(cuda):
    """qwen2-1.5b at full width, 4 layers, bf16, 4 × 2,048 tokens, two
    prefills under the benchmark's CUDA-only profiler: the profiler check
    reads True and each prefill records its spans.  On the second (the
    first holds the profiler's start): every kernel runs inside the host
    clock's ``prefill`` span, from its start to the host's sight of the
    device's end (kernels run after their launch), within 0.5 ms of the
    profiler's clock against the host's; and the request's device
    intervals, carried onto the profiler's clock (which drifts from the
    host's) by the line through K11's ends against their intervals' ends,
    hold each K11 kernel in exactly one ``kernel.flash_attention``
    interval, its end within 10 µs of the line, as many as the layers and
    as K11's launches (the count the benchmark's ``k11_launches``
    takes)."""
    import dataclasses
    import statistics
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4)
    params = tf.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    tf.prefill(params, cfg, toks, cache_len=2049)
    torch.cuda.synchronize()
    spans.clear()
    launches = fa.flash_attention_gqa.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enabled = torch.autograd._profiler_enabled()
        ends = []
        for _ in range(2):
            tf.prefill(params, cfg, toks, cache_len=2049)
            torch.cuda.synchronize()
            ends.append(time.time_ns() * 1e-9)
    assert enabled
    assert fa.flash_attention_gqa.launches - launches == 2 * cfg.n_layers
    kernels = sorted((k.start_ns() * 1e-9, k.end_ns() * 1e-9, k.name())
                     for k in prof.profiler.kineto_results.events()
                     if k.device_type() == torch.autograd.DeviceType.CUDA)
    reqs = spans.requests()
    assert len(reqs) == 2 and len(kernels) % 2 == 0
    recs = reqs[max(reqs)]
    top = next(r for r in recs if r["name"] == "prefill")
    mine = kernels[len(kernels) // 2:]
    assert all(top["start"] - 5e-4 <= s and e <= ends[1] + 5e-4
               for s, e, _ in mine)
    k11 = [(s, e) for s, e, n in mine if "flash_fwd" in n]
    ivs = sorted(r["dev"] for r in recs
                 if r["name"] == "kernel.flash_attention")
    assert len(ivs) == len(k11) == cfg.n_layers
    x0, y0 = ivs[0][1], k11[0][1]
    slope, y_at_x0 = statistics.linear_regression(
        [b - x0 for _, b in ivs], [e - y0 for _, e in k11])

    def on_trace(t):
        return y0 + y_at_x0 + slope * (t - x0)
    for (a, b), (_, e) in zip(ivs, k11):
        assert abs(on_trace(b) - e) <= 1e-5
        held = [k for k in k11
                if on_trace(a) - 1e-5 <= k[0] and k[1] <= on_trace(b) + 1e-5]
        assert len(held) == 1


# ------------------------------------------------------------ K12 and K13
def _routes(N, E, k, seed, skew=False):
    """(N, k) distinct experts a token, drawn from ``seed`` on the CPU;
    with ``skew`` nine tokens in ten lead with expert 0."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.argsort(torch.rand((N, E), generator=g), dim=-1)[:, :k]
    if skew:
        rest = torch.argsort(torch.rand((N, E - 1), generator=g), dim=-1) + 1
        led = torch.cat([torch.zeros((N, 1), dtype=ids.dtype),
                         rest[:, :k - 1]], dim=1)
        lead = torch.rand(N, generator=g) < 0.9
        ids = torch.where(lead[:, None], led, ids)
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,E,k,skew", [(8192, 4096, 8, 2, False),
                                          (8192, 4096, 8, 2, True),
                                          (4, 4096, 8, 2, False),
                                          (1000, 128, 384, 8, False)])
def test_moe_dispatch_and_combine_match_plain_versions(cuda, N, d, E, k,
                                                       skew):
    """K12 and K13 at the mixtral prefill cell's shapes (8,192 tokens of
    4,096, 8 experts, top 2), at a skewed load, at a decode step's batch of
    4 and at kimi's 384 experts, top 8: the same bits as their plain
    versions on the CPU, twice."""
    from repro_torch.kernels import moe as kmoe
    ids = _routes(N, E, k, seed=N + E, skew=skew)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((N, d), generator=g).bfloat16()
    w = torch.softmax(torch.randn((N, k), generator=g), -1)
    out = torch.randn((N * k, d), generator=g).bfloat16()
    want = kmoe.moe_dispatch_ref(x, ids, E)
    want_y = kmoe.moe_combine_ref(out, want[1], w)
    kmoe.reset_launch_counts()
    for _ in range(2):
        got = kmoe.moe_dispatch(x.to(cuda), ids.to(cuda), E)
        y = kmoe.moe_combine(out.to(cuda), got[1], w.to(cuda))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert torch.equal(y.cpu(), want_y)
    assert kmoe.launch_counts() == {"moe_dispatch": 2, "moe_combine": 2}
    f32 = kmoe.moe_combine(out.float().to(cuda), got[1], w.to(cuda))
    assert torch.equal(f32.cpu(), kmoe.moe_combine_ref(out.float(), want[1],
                                                       w))


@pytest.mark.cuda
def test_moe_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import moe as kmoe
    ids = torch.zeros((4, 2), dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kmoe.moe_dispatch(torch.zeros((4, 6), device=cuda,
                                      dtype=torch.bfloat16), ids, 4)
    with pytest.raises(TypeError, match="dtype"):
        kmoe.moe_dispatch(torch.zeros((4, 8), device=cuda,
                                      dtype=torch.float16), ids, 4)
    with pytest.raises(ValueError, match="one device"):
        kmoe.moe_dispatch(torch.zeros((4, 8)), ids, 4)


def _mixtral_stage(cuda, n_layers=16):
    """Mixtral-8x7B at full width, ``n_layers`` of its layers, bf16
    weights drawn on the card (the benchmark's draw), and the config."""
    import dataclasses
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.harness import moe_inputs
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=n_layers)
    c = {"n_layers": n_layers, "d_model": cfg.d_model,
         "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
         "head_dim": cfg.hd, "d_ff": cfg.moe_d_ff, "n_experts": cfg.n_experts,
         "top_k": cfg.top_k, "vocab_size": cfg.vocab_size,
         "dtype": cfg.dtype}
    return cfg, moe_inputs.program_tree(moe_inputs.make_weights(c, 0, cuda))


@pytest.mark.cuda
def test_mixtral_prefill_waits_for_no_host_and_launches_once_a_layer(cuda):
    """A 16-layer Mixtral prefill of 4 x 2,048 tokens through
    ``serve_lm.prefill`` under ``set_sync_debug_mode("error")``: nothing
    synchronises with the host; K12 and K13 launch once a MoE layer and
    K11 once a layer (the 4,096-token window covers the prompt); every
    assignment is computed."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models.layers import moe
    from repro_torch.serve import serve_lm
    resolve_device("cuda")
    cfg, params = _mixtral_stage(cuda)
    prompts = torch.randint(0, cfg.vocab_size, (4, 2048), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    serve_lm.prefill(params, cfg, prompts, 1)
    torch.cuda.synchronize()
    kmoe.reset_launch_counts()
    gr.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cache = serve_lm.prefill(params, cfg, prompts, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kmoe.launch_counts() == {"moe_dispatch": 16, "moe_combine": 16}
    assert gr.launch_counts()["flash_attention"] == 16
    assert len(out["moe"]) == 16
    assert all(moe.dropped(r) == 0 for r in out["moe"])
    assert bool(torch.isfinite(out["logits"]).all())
    assert cache["layers"][0].k.shape == (16, 4, 4096, 8, 128)


@pytest.mark.cuda
def test_reduced_mixtral_serves_on_the_card_as_on_the_cpu(cuda):
    """mixtral-8x7b reduced (f32): the dropless prefill and 4 decode steps
    on the card against the CPU from the same params: logits within 1e-4,
    the same experts in every layer."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm
    resolve_device("cuda")
    cfg = get_config("mixtral-8x7b").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(1))
    got = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else to_torch(params, cuda)
        out, cache = serve_lm.prefill(p, cfg, toks[:, :20].to(dev), 4)
        logits = [out["logits"]]
        for s in range(4):
            lg, cache = tf.decode_step(
                p, cfg, cache, toks[:, 20 + s:21 + s].to(dev),
                torch.full((4,), 20 + s, dtype=torch.int32, device=dev),
                moe_dispatch="dropless")
            logits.append(lg)
        got[dev] = (torch.cat(logits, 1).cpu(),
                    [r["experts"].cpu() for r in out["moe"]])
    np.testing.assert_allclose(got["cuda"][0].numpy(), got["cpu"][0].numpy(),
                               atol=1e-4)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ K14
#: d_model of every configuration of ``repro_torch.configs``.
NORM_WIDTHS = (768, 1024, 1536, 2048, 3072, 4096, 7168, 8192)


def _norm_inputs(cuda, rows, d, dtype, seed=14):
    """x (rows, d), each row normal at a scale of its own, and a float32
    scale 1 + 0.1·N(0, 1), drawn on the card."""
    g = torch.Generator(cuda).manual_seed(seed + rows + d)
    mag = torch.exp(torch.randn((rows, 1), generator=g, device=cuda))
    x = (torch.randn((rows, d), generator=g, device=cuda) * mag).to(dtype)
    return x, 1 + 0.1 * torch.randn(d, generator=g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [
    (8192, 1536, torch.bfloat16), (8192, 3072, torch.bfloat16),
    (32768, 1536, torch.bfloat16), (8192, 4096, torch.bfloat16),
    (7, 1536, torch.bfloat16)] + [
    (64, d, dt) for d in NORM_WIDTHS + (128,)
    for dt in (torch.bfloat16, torch.float32)],
    ids=lambda v: str(v).removeprefix("torch."))
def test_rms_norm_holds_the_rule_against_the_composite(cuda, rows, d, dtype):
    """K14 against the float32 composite on the same card tensors, at the
    four prefill cells' norms (bf16) and every config's width in bf16 and
    float32, under ``norm.RULE``: bf16 within 1 ulp of the composite,
    float32 within a relative 1e-6, and in both K14's worst error against
    float64 at most the composite's plus 1 ulp (``-s`` prints the
    readings, the share of elements that differ among them); a second
    launch gives the same bits; the launch plan is the mirror's."""
    from repro_torch.kernels import norm
    x, scale = _norm_inputs(cuda, rows, d, dtype)
    norm.reset_launch_counts()
    got, again = norm.rms_norm(x, scale), norm.rms_norm(x, scale)
    want = norm.rms_norm_ref(x, scale)
    r = norm.rule_readings(got, want, x, scale)
    print(f"rms_norm rows {rows} d {d} {dtype}: {r}")
    assert r["ok"], r
    assert torch.equal(got, again)
    assert norm.launch_counts() == {"rms_norm": 2}
    dt = str(dtype).removeprefix("torch.")
    plan = norm.plan(rows, d, dt)
    assert norm.launch_plan(rows, d, dt) == {k: plan[k]
                                             for k in ("warps", "blocks")}


@pytest.mark.cuda
def test_rms_norm_takes_the_prefills_rows_and_empty_ones(cuda):
    from repro_torch.kernels import norm
    x, scale = _norm_inputs(cuda, 6, 1536, torch.bfloat16)
    y = norm.rms_norm(x.reshape(2, 3, 1536), scale)
    assert y.shape == (2, 3, 1536) and torch.equal(
        y.reshape(6, 1536), norm.rms_norm(x, scale))
    empty = norm.rms_norm(x[:0], scale)
    assert empty.shape == (0, 1536)


@pytest.mark.cuda
def test_rms_norm_refusals_on_the_card(cuda):
    from repro_torch.kernels import norm
    x, scale = _norm_inputs(cuda, 4, 128, torch.bfloat16)
    norm.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        norm.rms_norm(x[:, :12].contiguous(), scale[:12].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        norm.rms_norm(x.half(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        norm.rms_norm(x[:, ::2], scale[:64].contiguous())
    with pytest.raises(ValueError, match="16-byte"):
        norm.rms_norm(x.reshape(-1)[4:4 + 3 * 128].reshape(3, 128), scale)
    with pytest.raises(NotImplementedError, match="forward only"):
        norm.rms_norm(x.float().requires_grad_(), scale)
    with pytest.raises(ValueError, match="one device"):
        norm.rms_norm(x, scale.cpu())
    assert norm.launch_counts() == {"rms_norm": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi4-mini-3.8b"])
def test_serve_prefill_launches_k14_once_a_norm(cuda, arch):
    """A served prefill of 4 × 2,048 tokens at full width launches K14 at
    each of its 2 · n_layers + 1 norms (57 for qwen2-1.5b, 65 for
    phi4-mini-3.8b), counts at 0 just before, and its decode never."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import norm
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm
    resolve_device("cuda")
    cfg = get_config(arch)
    params = serve_lm.load_model(cfg, seed=0, device=cuda)
    prompts = serve_lm.make_prompts(cfg, 4, 2048, seed=0, device=cuda)
    norm.reset_launch_counts()
    out, cache = serve_lm.prefill(params, cfg, prompts, 1)
    torch.cuda.synchronize()
    want = {"qwen2-1.5b": 57, "phi4-mini-3.8b": 65}[arch]
    assert want == 2 * cfg.n_layers + 1
    assert norm.launch_counts() == {"rms_norm": want}
    assert bool(torch.isfinite(out["logits"]).all())
    norm.reset_launch_counts()
    tf.decode_step(params, cfg, cache, prompts[:, -1:],
                   torch.full((4,), 2048, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert norm.launch_counts() == {"rms_norm": 0}


def _parent_norm(p, x, kind="rmsnorm", eps=1e-6):
    """``apply_norm`` as it was before K14, verbatim."""
    xf = x.float()
    if kind == "rmsnorm":
        nrm = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (nrm * p["scale"]).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"] + p["bias"]).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_on_the_card_keeps_the_parents_bits(cuda, dtype,
                                                     monkeypatch):
    """Training's forward under autograd on the card (qwen2-1.5b reduced,
    remat on): logits and every parameter's gradient equal, bit for bit,
    those of the forward with the parent's composite norm; K14 never
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import leaf_paths, to_torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import norm
    from repro_torch.models import transformer as tf
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype=dtype)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))

    def run():
        params = to_torch(tf.init_params(
            cfg, torch.Generator().manual_seed(0)), cuda)
        leaves = [t for _, t in leaf_paths(params)
                  if t.is_floating_point()]
        for t in leaves:
            t.requires_grad_()
        out = tf.forward(params, cfg, toks)
        out["logits"].float().square().mean().backward()
        return out["logits"].detach(), [t.grad for t in leaves]

    norm.reset_launch_counts()
    logits, grads = run()
    assert norm.launch_counts() == {"rms_norm": 0}
    # Every apply_norm call (norm1, norm2, the final norm) computes the
    # parent's RMSNorm.
    from repro_torch.models.layers import common
    monkeypatch.setattr(common, "rms_norm_ref", lambda x, scale, eps: (
        _parent_norm({"scale": scale}, x, "rmsnorm", eps)))
    want, want_grads = run()
    assert torch.equal(logits, want)
    assert len(grads) == len(want_grads)
    for a, b in zip(grads, want_grads):
        assert torch.equal(a, b)
