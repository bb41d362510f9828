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


@pytest.mark.parametrize("B,C", SHAPES)
@pytest.mark.parametrize("triple", [(GAMMA, KAPPA, GAMMA), (1.0, 0.0, 0.0)])
def test_plain_backward_closed_forms_match_jax_kernels(triple, B, C):
    """The plain versions of K2/K3 against the reference's backward kernels
    (interpret mode), for the full-regularizer and cross-only triples."""
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

