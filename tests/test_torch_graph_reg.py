"""Graph-regularizer kernels of the PyTorch port against the JAX reference.

The same numpy inputs go through the reference's Pallas entries (interpret
mode on the CPU, as tests/test_fused_kernels.py runs them) and through the
port's registry entries, which on CPU tensors run the plain versions behind
the same ``torch.autograd.Function`` the GPU path uses.  Forward values,
``dlogp`` and ``dW`` (``jax.vjp`` against ``torch.autograd``) must agree.

Tolerances: both sides sum float32 products in different orders (Pallas
tiles vs one dense matmul), so values agree to ~1e-6 relative; the tests
allow rtol 2e-5 with an atol of 2e-5 of the largest magnitude.

The kernels themselves are held against their plain versions on the card
in ``tests/test_torch_kernels_cuda.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.graph_reg import graph_reg_bwd_pallas  # noqa: E402
from repro_torch.api.registry import PAIRWISE, resolve_pairwise  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.tuning import TileSpec, refuse_pinned  # noqa: E402

RTOL = 2e-5
SHAPES = [(200, 39), (64, 8), (256, 39)]
GAMMA, KAPPA = 0.8, 1e-2


def _problem(B, C, seed=0, density=0.2):
    rng = np.random.default_rng(seed + 7 * B + C)
    logits = rng.normal(size=(B, C)).astype(np.float32) * 2.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)), np.float32)
    W = np.abs(rng.normal(size=(B, B))) * (rng.random((B, B)) < density)
    return logp, W.astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jax_fn(entry):
    if entry in ("fused", "auto", "blocksparse"):
        return lambda lp, w: jops.graph_regularizer_fused(lp, w, GAMMA, KAPPA)
    return jops.graph_reg_pairwise_pallas_vjp


def _torch_fn(entry):
    impl = resolve_pairwise(entry)
    if getattr(impl, "full_regularizer", False):
        return lambda lp, w: impl(lp, w, GAMMA, KAPPA)
    return impl


@pytest.mark.parametrize("B,C", SHAPES)
@pytest.mark.parametrize("entry", ["fused", "pallas", "ref", "auto",
                                   "blocksparse"])
def test_entry_forward_and_vjp_match_jax(entry, B, C):
    logp, W = _problem(B, C)
    g = 0.37
    want, vjp = jax.vjp(_jax_fn(entry), jnp.asarray(logp), jnp.asarray(W))
    want_dlogp, want_dW = vjp(jnp.float32(g))

    lp = torch.tensor(logp, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    got = _torch_fn(entry)(lp, w)
    assert got.shape == ()
    got_dlogp, got_dW = torch.autograd.grad(got, (lp, w),
                                            torch.tensor(g))
    _close(got.item(), float(want))
    _close(got_dlogp.numpy(), want_dlogp)
    _close(got_dW.numpy(), want_dW)


# Narrow B and wide C, where K2 takes its class route on the card: an LM
# head's B 16 over 4,096 classes, a ragged B 17 over C 1001 (not a
# multiple of 4), the smoke's B 4 over V 512.
NARROW_SHAPES = [(16, 4096), (17, 1001), (4, 512)]


@pytest.mark.parametrize("B,C", SHAPES + NARROW_SHAPES)
@pytest.mark.parametrize("triple", [(GAMMA, KAPPA, GAMMA), (1.0, 0.0, 0.0)])
def test_plain_backward_closed_forms_match_jax_kernels(triple, B, C):
    """The plain versions of K2/K3 against the reference's backward kernels
    (interpret mode), for the full-regularizer and cross-only triples,
    also at the narrow-B, wide-C shapes of K2's class route (RTOL, as
    elsewhere: both sum float32 products over B in other orders)."""
    logp, W = _problem(B, C, seed=1)
    gc, kappa, ge = triple
    g = 1.3
    want_dlogp, want_dW = graph_reg_bwd_pallas(
        jnp.asarray(logp), jnp.asarray(W), jnp.float32(g), gamma=gc,
        kappa=kappa, ent_weight=ge)
    lp, w, gt = torch.tensor(logp), torch.tensor(W), torch.tensor(g)
    _close(ref.reg_bwd_dlogp_ref(lp, w, gt, gc, kappa, ge).numpy(),
           want_dlogp)
    _close(ref.reg_bwd_dw_ref(lp, gt, gc, ge).numpy(), want_dW)
    want_fwd = jops._reg_primal(jnp.asarray(logp), jnp.asarray(W), gc,
                                kappa, ge, None)
    _close(ref.reg_forward_ref(lp, w, gc, kappa, ge).item(), float(want_fwd))


def test_worker_axis_equals_per_worker_calls():
    """A (k, B, C) call gives each worker's value and gradient exactly as
    k separate calls would (the kernels' grid z)."""
    probs = [_problem(96, 39, seed=s) for s in range(3)]
    lp = torch.tensor(np.stack([p[0] for p in probs]), requires_grad=True)
    w = torch.tensor(np.stack([p[1] for p in probs]))
    out = ops.graph_regularizer_fused(lp, w, GAMMA, KAPPA)
    assert out.shape == (3,)
    cot = torch.tensor([0.5, -1.0, 2.0])
    (dlp,) = torch.autograd.grad(out, lp, cot)
    for z, (logp, W) in enumerate(probs):
        one = torch.tensor(logp, requires_grad=True)
        val = ops.graph_regularizer_fused(one, torch.tensor(W), GAMMA, KAPPA)
        (d1,) = torch.autograd.grad(val, one, cot[z])
        _close(out[z].item(), val.item(), rtol=1e-6)
        _close(dlp[z].numpy(), d1.numpy(), rtol=1e-6)


def test_backward_skips_dw_when_w_needs_no_gradient(monkeypatch):
    """Training's W is batch data: the backward must not compute dW (K3)."""
    def boom(*a, **k):
        raise AssertionError("reg_bwd_dw called though W needs no gradient")
    monkeypatch.setattr(gr, "reg_bwd_dw", boom)
    logp, W = _problem(64, 8)
    lp = torch.tensor(logp, requires_grad=True)
    out = ops.graph_regularizer_fused(lp, torch.tensor(W), GAMMA, KAPPA)
    out.backward()
    assert lp.grad is not None and torch.isfinite(lp.grad).all()


def test_registry_names_and_markers_match_reference():
    from repro.api.registry import PAIRWISE as JPAIRWISE
    assert PAIRWISE.names() == JPAIRWISE.names()
    for name in PAIRWISE.names():
        for marker in ("full_regularizer", "accepts_tiles", "accepts_layout"):
            assert (getattr(PAIRWISE.get(name), marker, False)
                    == getattr(JPAIRWISE.get(name), marker, False)), (name,
                                                                     marker)


def test_blocksparse_layout_computes_and_refuses_other_pinned_bi(
        monkeypatch):
    """With a layout the entry computes (K4–K7's plain versions here); on
    the card path a pinned bi other than the layout's tile edge raises."""
    from repro_torch.core.metabatch import block_layout
    logp, W = _problem(64, 8)
    lay = block_layout(W, 32)
    lp = torch.tensor(logp, requires_grad=True)
    val = ops.graph_regularizer_blocksparse(lp, torch.tensor(W), GAMMA,
                                            KAPPA, layout=lay)
    val.backward()
    _close(val.item(), ops.graph_regularizer_fused(
        torch.tensor(logp), torch.tensor(W), GAMMA, KAPPA).item())
    assert torch.isfinite(lp.grad).all()
    # The card path's check runs before any kernel: fake a CUDA tensor.
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(ValueError, match="only bi=32"):
        ops.graph_regularizer_blocksparse(torch.tensor(logp), torch.tensor(W),
                                          GAMMA, KAPPA, layout=lay,
                                          tiles=TileSpec(bi=64))


def test_pinned_tiles_are_refused_for_cuda_kernels():
    refuse_pinned(None, "k")
    refuse_pinned(TileSpec(), "k")
    with pytest.raises(ValueError, match="fixed block shapes"):
        refuse_pinned(TileSpec(bi=64), "graph_regularizer")
    # The plain CPU path has no tiles and takes any spec.
    logp, W = _problem(64, 8)
    out = ops.graph_regularizer_fused(torch.tensor(logp), torch.tensor(W),
                                      GAMMA, KAPPA, tiles=TileSpec(bi=64))
    assert torch.isfinite(out)


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version; anything that is neither CPU nor
    CUDA raises instead of silently falling back: mixed devices, and
    ``meta`` tensors for a kernel without a shape rule (K3; K1 and K2
    take theirs, the dry run's)."""
    logp = torch.zeros(1, 8, 4, device="meta")
    W = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gr.reg_forward(logp, torch.zeros(1, 8, 8), 1.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gr.reg_bwd_dw(logp, torch.ones(1, device="meta"), 1.0, 1.0)
    assert gr.reg_forward(logp, W, 1.0, 0.0, 1.0).device.type == "meta"


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """No compiler: the build raises, it never falls back to the plain path."""
    from repro_torch.kernels import build
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("graph_reg")
    # The library name is keyed on the source text and the flags.
    path = build.library_path("graph_reg")
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("libgraph_reg-") and path.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("graph_reg") != path


def test_launch_counters_reset_and_untouched_by_plain_path():
    gr.reset_launch_counts()
    logp, W = _problem(64, 8)
    ops.graph_regularizer_fused(torch.tensor(logp), torch.tensor(W), 1.0, 0.0)
    ops.graph_reg_pairwise(torch.tensor(logp), torch.tensor(W))
    x = torch.tensor(logp)
    ops.knn_topk(x, x, 3, exclude_self=True)
    ops.rbf_affinity(x, x, 1.0)
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1])
    assert gr.launch_counts() == {
        name: 0 for name in ("graph_reg_fwd", "graph_reg_bwd_dlogp",
                             "graph_reg_bwd_dw", "graph_reg_bsp_fwd",
                             "graph_reg_bsp_bterm", "graph_reg_bsp_dlogp",
                             "graph_reg_bsp_dw", "graph_reg_pairwise",
                             "knn_topk", "rbf_affinity", "flash_attention")}



# ---------------------------------------------------------------- K1 plans
# K1's and K2's launch plans (``graph_reg_fwd_plan`` and
# ``graph_reg_bwd_dlogp_plan`` in ``csrc/graph_reg.cu``) have Python
# mirrors, ``gr.fwd_plan`` and ``gr.dlogp_plan``: their constants are held
# to the source here and their results to the library on the card
# (tests/test_torch_kernels_cuda.py).
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
_CS_CONSTANTS = {"kCsSlab": gr.CS_SLAB, "kCsTile": gr.CS_TILE,
                 "kCsStages": gr.CS_STAGES, "kCsMaxGroups": gr.CS_MAX_GROUPS,
                 "kCsSumThreads": gr.CS_SUM_THREADS,
                 # K2's class route
                 "kDcMaxRows": gr.DC_MAX_ROWS, "kDcRows": gr.DC_ROWS,
                 "kDcWarps": gr.DC_WARPS, "kDcStages": gr.DC_STAGES,
                 "kDcMinSpan": gr.DC_MIN_SPAN,
                 "kDcSmBlocks": gr.DC_SM_BLOCKS}


@pytest.mark.parametrize("const", sorted(_CS_CONSTANTS))
def test_class_split_constants_follow_the_source(const):
    src = (CSRC / "graph_reg.cu").read_text()
    assert int(re.search(rf"constexpr int {const} = (\d+);", src).group(1)) \
        == _CS_CONSTANTS[const]
    assert re.search(r"constexpr int kCsStride = kCsSlab \+ 4;", src)
    assert gr.CS_STRIDE == gr.CS_SLAB + 4
    assert re.search(r"constexpr int kDcMaxThreads = "
                     r"32 \* \(kDcMaxRows / kDcRows\);", src)
    assert gr.DC_MAX_THREADS == 32 * (gr.DC_MAX_ROWS // gr.DC_ROWS)


# (k, B, C): the paper's shapes (P = 2176 on the card's machine, 2112 on a
# smaller corpus, k 1, 2, 4), the ragged shapes chip_smoke.py holds bit for
# bit against the parent (k 3 / 1, B 1001, C 100 / 200) and a narrow C at
# wide B, with the parent's plans (rows a block, dynamic shared memory
# bytes, workspace floats) on 132 SMs.
ROW_PLANS = {(1, 2176, 39): (20, 101824, 104448),
             (4, 2176, 39): (32, 122368, 417792),
             (1, 2112, 39): (16, 94976, 101376),
             (2, 1000, 39): (16, 94976, 96384),
             (3, 1001, 100): (24, 160896, 324876),
             (1, 1001, 200): (8, 123264, 208392),
             (1, 4096, 4): (32, 55808, 49152),
             (1, 528, 300): (8, 123264, 162752)}


@pytest.mark.parametrize("shape", sorted(ROW_PLANS))
def test_fwd_plan_keeps_the_row_plan_at_the_papers_shapes(shape):
    """Where the row plan is above its least (4 rows a block) or C spans
    at most 4 class chunks, K1 keeps the parent's plan exactly, and with
    it its bits."""
    plan = gr.fwd_plan(*shape, n_sm=132)
    rows, smem, work = ROW_PLANS[shape]
    assert plan["route"] == "rows" and plan["class_chunk"] == 0
    assert (plan["rows_per_block"], plan["dynamic_smem_bytes"],
            plan["workspace_floats"]) == (rows, smem, work)
    assert not gr.class_split(*shape, n_sm=132)


# Every LM head of chip_smoke.LM_HEAD_SHAPES (qwen2-1.5b's V at k 1 and
# 2, a ragged B, the SSL heads of mixtral and xlstm-125m, gpt-2's ragged
# V 50257, the smoke's B 4 over V 512, phi4-mini-3.8b's V 200064 with a
# ragged last chunk, yi-9b's 64000, musicgen-large's 2048, kimi-k2's
# 163840, llama-3.2-vision's 128256 and jamba's 65536) and a wide B that
# takes row tiles: (class chunk, chunks, class groups) on 132 SMs.
CLASS_PLANS = {(1, 16, 200064): (1408, 143, 16),
               (1, 16, 64000): (384, 167, 16),
               (1, 16, 2048): (128, 16, 16),
               (1, 16, 163840): (1152, 143, 16),
               (1, 16, 128256): (896, 144, 16),
               (1, 16, 65536): (384, 171, 16),
               (1, 16, 151936): (1024, 149, 16),
               (2, 16, 151936): (2176, 70, 16),
               (1, 17, 32000): (128, 250, 8),
               (1, 16, 32000): (128, 250, 16),
               (1, 16, 50304): (256, 197, 16),
               (1, 16, 50257): (256, 197, 16),
               (1, 4, 512): (128, 4, 32),
               (1, 100, 151936): (4480, 34, 1)}


@pytest.mark.parametrize("shape", sorted(CLASS_PLANS))
def test_fwd_plan_splits_classes_at_the_lm_heads(shape):
    """At the LM heads the row plan is at its least and C spans many
    class chunks: K1 splits C into whole 128-class slabs, as many a chunk
    as still give every SM a block; a block owns a min(B, 64)-square tile
    of P·logPᵀ, its 256 threads 4 × 4 entries each in up to 32 class
    groups; the workspace holds a (B, B) partial a chunk and worker."""
    k, B, C = shape
    n_sm = 132
    plan = gr.fwd_plan(k, B, C, n_sm=n_sm)
    chunk, n_chunks, groups = CLASS_PLANS[shape]
    assert gr.class_split(k, B, C, n_sm=n_sm)
    assert plan["route"] == "classes"
    assert (plan["class_chunk"], plan["class_chunks"],
            plan["class_groups"]) == (chunk, n_chunks, groups)
    assert chunk % gr.CS_SLAB == 0
    assert (n_chunks - 1) * chunk < C <= n_chunks * chunk
    nt = -(-B // gr.CS_TILE)
    assert plan["blocks"] == k * n_chunks * nt * nt
    # Every SM gets a block, unless C has fewer slabs than the card SMs.
    assert plan["blocks"] >= min(n_sm, k * nt * nt * -(-C // gr.CS_SLAB))
    assert plan["rows_per_block"] == min(B, gr.CS_TILE)
    quads = -(-min(B, gr.CS_TILE) // 4)
    assert groups * quads * quads <= 256 < 2 * groups * quads * quads \
        or groups == gr.CS_MAX_GROUPS
    assert plan["dynamic_smem_bytes"] <= 232_448
    assert plan["workspace_floats"] == k * n_chunks * B * B


@pytest.mark.parametrize("shape", sorted(ROW_PLANS) + sorted(CLASS_PLANS))
def test_fwd_workspace_covers_both_plans(shape):
    """The workspace the library sizes holds what each plan's launches
    write there: the row plan's partials and class-padded logP, or the
    class-split plan's chunk partials (their launch models'
    outputs)."""
    from repro_torch.analysis import launch_audit as la
    k, B, C = shape
    plan = gr.fwd_plan(k, B, C, n_sm=132)
    written = {ln.kernel: sum(int(np.prod(o.shape)) for o in ln.outputs)
               for ln in la.call_launches("graph_reg_fwd", k=k, B=B, C=C)}
    if plan["route"] == "rows":
        # pad_classes writes float4s: 4 floats an element of its output.
        want = written["reg_fwd_partials"] + 4 * written["pad_classes"]
        assert set(written) == {"pad_classes", "reg_fwd_partials",
                                "reg_fwd_tree_sum"}
    else:
        want = written["reg_fwd_class_partials"]
        assert set(written) == {"reg_fwd_class_partials",
                                "reg_fwd_class_sum"}
    assert plan["workspace_floats"] == want


# K2's row route at the same shapes and at the paper's k = 2 (the
# parent's plans, unchanged: rows a block, dynamic shared memory bytes,
# workspace floats on 132 SMs).
DLOGP_ROW_PLANS = {(1, 2176, 39): (36, 19456, 174080),
                   (2, 2176, 39): (64, 26624, 348160),
                   (4, 2176, 39): (64, 26624, 696320),
                   (1, 2112, 39): (32, 18432, 168960),
                   (2, 2112, 39): (64, 26624, 337920),
                   (4, 2112, 39): (64, 26624, 675840),
                   (2, 1000, 39): (32, 18432, 160000),
                   (3, 1001, 100): (40, 35840, 600600),
                   (1, 1001, 200): (32, 40960, 400400),
                   (1, 4096, 4): (64, 17408, 32768),
                   (1, 528, 300): (24, 38912, 316800)}


@pytest.mark.parametrize("shape", sorted(DLOGP_ROW_PLANS))
def test_dlogp_plan_keeps_the_row_route_at_the_papers_shapes(shape):
    """Past ``DC_MAX_ROWS`` rows (or within one 128-class chunk) K2 keeps
    the parent's row route exactly: two-block clusters after the class
    padding, and with them its bits."""
    k, B, C = shape
    plan = gr.dlogp_plan(k, B, C, n_sm=132)
    assert gr.dlogp_route(B, C) == plan["route"] == "rows"
    assert plan["class_span"] == 0
    assert (plan["rows_per_block"], plan["dynamic_smem_bytes"],
            plan["workspace_floats"]) == DLOGP_ROW_PLANS[shape]
    quads = min(-(-C // 4), gr.DL_MAX_QUADS)
    assert plan["threads"] == plan["rows_per_block"] // 2 * quads
    assert plan["blocks"] == 2 * k * -(-B // plan["rows_per_block"]) \
        * -(-C // (4 * gr.DL_MAX_QUADS))


# Every LM head (chip_smoke.LM_HEAD_SHAPES) and ragged narrow shapes on
# K2's class route: (class span, tile classes, threads, blocks) on 132
# SMs.
DLOGP_CLASS_PLANS = {(1, 16, 200064): (760, 256, 256, 264),
                     (1, 16, 64000): (244, 244, 256, 263),
                     (1, 16, 2048): (128, 128, 128, 16),
                     (1, 16, 163840): (624, 256, 256, 263),
                     (1, 16, 128256): (488, 256, 256, 263),
                     (1, 16, 65536): (252, 252, 256, 261),
                     (1, 16, 151936): (576, 256, 256, 264),
                     (2, 16, 151936): (1152, 256, 256, 264),
                     (1, 17, 32000): (128, 128, 160, 250),
                     (1, 16, 32000): (128, 128, 128, 250),
                     (1, 16, 50304): (192, 192, 256, 262),
                     (1, 16, 50257): (192, 192, 256, 262),
                     (1, 4, 512): (128, 128, 32, 4),
                     (2, 33, 777): (128, 128, 288, 14),
                     (1, 64, 1000): (128, 128, 512, 8)}


@pytest.mark.parametrize("shape", sorted(DLOGP_CLASS_PLANS))
def test_dlogp_plan_takes_the_class_route_at_the_lm_heads(shape):
    """At narrow B and wide C K2 takes its class route: a block owns a
    span of whole quads, as wide as lets the blocks of all workers fill
    each SM twice (at least a warp's 128 classes), and all B rows; its
    threads are 4-row groups of whole warps, 8 warps shared among them
    (one a group at least), 4 classes a thread; no workspace."""
    k, B, C = shape
    n_sm = 132
    plan = gr.dlogp_plan(k, B, C, n_sm=n_sm)
    span, tile, threads, blocks = DLOGP_CLASS_PLANS[shape]
    assert gr.dlogp_route(B, C) == plan["route"] == "classes"
    assert (plan["class_span"], plan["tile_classes"], plan["threads"],
            plan["blocks"]) == (span, tile, threads, blocks)
    assert plan["rows_per_block"] == B and plan["workspace_floats"] == 0
    assert span % 4 == 0 and span >= gr.DC_MIN_SPAN
    assert (blocks // k - 1) * span < C <= blocks // k * span
    assert blocks <= max(gr.DC_SM_BLOCKS * n_sm,
                         k * -(-C // gr.DC_MIN_SPAN))
    groups = -(-B // gr.DC_ROWS)
    assert threads % (32 * groups) == 0
    assert 4 * (threads // groups) >= tile
    assert threads <= max(32 * gr.DC_WARPS, 32 * groups) \
        <= gr.DC_MAX_THREADS
    assert plan["dynamic_smem_bytes"] <= 232_448


@pytest.mark.parametrize("shape", sorted(DLOGP_ROW_PLANS)
                         + sorted(DLOGP_CLASS_PLANS))
def test_dlogp_workspace_covers_both_routes(shape):
    """K2's workspace is what its launch models write there: the row
    route's class-padded P and logP (``pad_classes``), nothing on the
    class route, which launches one kernel."""
    from repro_torch.analysis import launch_audit as la
    k, B, C = shape
    plan = gr.dlogp_plan(k, B, C, n_sm=132)
    written = {ln.kernel: sum(int(np.prod(o.shape)) for o in ln.outputs)
               for ln in la.call_launches("graph_reg_bwd_dlogp", k=k, B=B,
                                          C=C)}
    if plan["route"] == "rows":
        assert set(written) == {"pad_classes", "reg_bwd_dlogp"}
        # pad_classes writes float4s: 4 floats an element of its output.
        assert plan["workspace_floats"] == 4 * written["pad_classes"]
    else:
        assert set(written) == {"reg_bwd_dlogp_classes"}
        assert plan["workspace_floats"] == 0


# ------------------------------------------- K1's class-split sum order
def _fma(a, b, c):
    """fmaf in float32: a·b + c rounded once (float64 holds the product of
    two float32 values exactly; the sum may round twice, rarely)."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def class_split_forward(logp, W, gc, kappa, ge, plan, full=True):
    """K1 on the class-split plan, in its kernels' order, on the CPU:
    pass 1 sums each chunk's classes per class group (one fmaf chain in
    increasing c from +0; group g takes classes g·w .. g·w + w of every
    128-class slab), adds the groups in order; pass 2 adds the chunks in
    order from +0, then thread t (of ``CS_SUM_THREADS``) chains W_e·S_e
    over entries e ≡ t and the rows i ≡ t (degree in increasing j, H_i =
    −S_ii), and the threads' values are summed by a warp butterfly and
    the warps in order.  logp, W: (k, B, C), (k, B, B) float32 numpy; returns (k,)."""
    k, B, C = logp.shape
    chunk, n_chunks = plan["class_chunk"], plan["class_chunks"]
    groups = plan["class_groups"]
    w, slabs = gr.CS_SLAB // groups, chunk // gr.CS_SLAB
    gc, kappa, ge = (np.float32(x) for x in (gc, kappa, ge))
    threads = gr.CS_SUM_THREADS
    out = np.zeros(k, np.float32)
    for z in range(k):
        pad = np.zeros((2, B, n_chunks * chunk), np.float32)
        pad[0, :, :C] = np.exp(logp[z])
        pad[1, :, :C] = logp[z]
        # class c = u·chunk + s·128 + g·w + t
        Pr, Lr = pad.reshape(2, B, n_chunks, slabs, groups, w)
        acc = np.zeros((n_chunks, groups, B, B), np.float32)
        for s in range(slabs):
            for t in range(w):
                a = Pr[:, :, s, :, t].transpose(1, 2, 0)[..., :, None]
                b = Lr[:, :, s, :, t].transpose(1, 2, 0)[..., None, :]
                acc = _fma(a, b, acc)
        part = acc[:, 0]
        for g in range(1, groups):
            part = part + acc[:, g]
        S = np.zeros((B, B), np.float32)
        for u in range(n_chunks):
            S = S + part[u]
        Wz, Sf = W[z].reshape(-1), S.reshape(-1)
        cross = np.zeros(threads, np.float32)
        for e0 in range(0, B * B, threads):
            n = min(threads, B * B - e0)
            cross[:n] = _fma(Wz[e0:e0 + n], Sf[e0:e0 + n], cross[:n])
        ent = np.zeros(threads, np.float32)
        if full:
            deg = np.zeros(B, np.float32)
            for j in range(B):
                deg = deg + W[z][:, j]
            h = -np.diagonal(S)
            coef = _fma(ge, deg, kappa)
            for i0 in range(0, B, threads):
                n = min(threads, B - i0)
                ent[:n] = _fma(coef[i0:i0 + n], h[i0:i0 + n], ent[:n])
        v = _fma(-gc, cross, -ent).reshape(-1, 32)
        lane = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[:, lane ^ o]
        total = np.float32(0)
        for warp_total in v[:, 0]:
            total = np.float32(total + warp_total)
        out[z] = total
    return out


def _lm_problem(k, B, C, seed):
    """The LM head's inputs, as chip_smoke.lm_inputs makes them: logP of
    (k, B, C) logits 2·N(0, 1), a symmetric dense W (half its entries
    non-zero)."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (2.0 * rng.standard_normal((k, B, C))).astype(np.float32))
    W = rng.random((k, B, B)) * (rng.random((k, B, B)) < 0.5)
    W = (W + W.transpose(0, 2, 1)).astype(np.float32)
    return torch.log_softmax(logits, dim=-1).numpy(), W


def test_class_split_order_within_k1_lm_rule_of_float64():
    """qwen2-1.5b's LM head, (1, 16, 151936) at γ = 0.05, κ = 1e-4 on 132
    SMs, summed in the class-split plan's order, against the float64
    value: within 4·√C·2^-24·M, M = γ·Σ W·Hc + Σ (κ + γ·deg)·H
    (chip_smoke.K1_LM_RULE; the round-off of a C-term float32 chain grows
    as √C·u of the terms' magnitude).  Each chain is now 1,024 / 16 = 64
    classes long, so the error also holds with n = 243 for C, the plan's
    longest chain (chip_smoke.K1_CS_RULE)."""
    k, B, C = 1, 16, 151936
    gamma, kappa = 0.05, 1e-4
    logp, W = _lm_problem(k, B, C, seed=B + k)
    plan = gr.fwd_plan(k, B, C, n_sm=132)
    got = class_split_forward(logp, W, gamma, kappa, gamma, plan)
    lp64, W64 = torch.from_numpy(logp).double(), torch.from_numpy(W).double()
    want = ref.reg_forward_ref(lp64, W64, gamma, kappa, gamma).numpy()
    M = ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma).numpy()
    tol = 4.0 * C ** 0.5 * 2.0 ** -24 * np.abs(M).max()
    n = gr.class_split_chain(B, plan)
    assert n == 243
    tol_cs = 4.0 * n ** 0.5 * 2.0 ** -24 * np.abs(M).max()
    err = np.abs(got.astype(np.float64) - want).max()
    print(f"class-split order at {(k, B, C)}: |Δ vs float64| {err:.3e}, "
          f"tol {tol:.3e}, err/tol {err / tol:.4f}; with n = {n}: tol "
          f"{tol_cs:.3e}, err/tol {err / tol_cs:.4f}")
    assert err <= tol
    assert err <= tol_cs


@pytest.mark.parametrize("shape,chain", [((1, 16, 200064), 261),
                                         ((1, 16, 64000), 221),
                                         ((1, 16, 2048), 54)])
def test_class_split_order_within_k1_lm_rule_at_the_new_heads(shape, chain):
    """The SSL heads of phi4-mini-3.8b (V 200064: 143 chunks of 1,408
    classes, the last ragged), yi-9b (64000) and musicgen-large (2048: 16
    chunks of one slab) in the class-split plan's order, against float64:
    within K1_LM_RULE (n = C) and K1_CS_RULE (n = the plan's longest
    chain), as chip_smoke.lm_kernel_phase holds the card's kernel."""
    k, B, C = shape
    gamma, kappa = 0.05, 1e-4
    logp, W = _lm_problem(k, B, C, seed=B + k)
    plan = gr.fwd_plan(k, B, C, n_sm=132)
    assert gr.class_split_chain(B, plan) == chain
    got = class_split_forward(logp, W, gamma, kappa, gamma, plan)
    lp64, W64 = torch.from_numpy(logp).double(), torch.from_numpy(W).double()
    want = ref.reg_forward_ref(lp64, W64, gamma, kappa, gamma).numpy()
    M = np.abs(ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma)
               .numpy()).max()
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= 4.0 * C ** 0.5 * 2.0 ** -24 * M
    assert err <= 4.0 * chain ** 0.5 * 2.0 ** -24 * M


@pytest.mark.parametrize("shape", [(1, 4, 4096), (2, 17, 1001),
                                   (1, 70, 600)])
def test_class_split_order_matches_the_jax_fused_forward(shape):
    """A small wide shape, a ragged one (B 17, C 1001: 8 class groups, C
    not a multiple of 4) and one of 2 × 2 row tiles (B 70), in the
    class-split plan's order, against the reference's fused forward
    (Pallas, interpret mode) per worker, full regularizer and bare cross
    term (K10's).  Both are float32 sums of C-term chains in other
    orders: each within 4·√C·2^-24·M of float64 (K1_LM_RULE), so they
    are held to each other within twice that."""
    k, B, C = shape
    gamma, kappa = 0.05, 1e-4
    logp, W = _lm_problem(k, B, C, seed=sum(shape))
    plan = gr.fwd_plan(k, B, C, n_sm=132)
    assert plan["route"] == "classes"
    full = class_split_forward(logp, W, gamma, kappa, gamma, plan)
    cross = class_split_forward(logp, W, 1.0, 0.0, 0.0, plan, full=False)
    lp64, W64 = torch.from_numpy(logp).double(), torch.from_numpy(W).double()
    M = ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma).numpy()
    M_cross = ref.reg_forward_ref(lp64, W64, 1.0, 0.0, 0.0).numpy()
    for z in range(k):
        lp, w = jnp.asarray(logp[z]), jnp.asarray(W[z])
        want = float(jops.graph_regularizer_fused(lp, w, gamma, kappa))
        want_cross = float(jops.graph_regularizer_fused(lp, w))
        tol = 8.0 * C ** 0.5 * 2.0 ** -24
        assert abs(float(full[z]) - want) <= tol * abs(M[z])
        assert abs(float(cross[z]) - want_cross) <= tol * abs(M_cross[z])
