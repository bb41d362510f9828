"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them; the
file imports neither JAX nor the reference package, so it runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance: the kernels and the plain versions (cuBLAS products) sum float32
terms in different orders; rtol 2e-5 with an atol of 2e-5 of the largest
magnitude.  Repeats must be bit-identical: the kernels use no atomics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
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
@pytest.mark.parametrize("B,C", [(200, 8), (200, 39), (257, 70)])
def test_kernels_match_plain_versions(cuda, B, C):
    probs = [_problem(B, C, seed=s) for s in range(2)]
    logp = torch.stack([p[0] for p in probs]).to(cuda)
    W = torch.stack([p[1] for p in probs]).to(cuda)
    g = torch.tensor([0.5, -2.0], device=cuda)
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
    assert gr.launch_counts() == {"graph_reg_fwd": 1,
                                  "graph_reg_bwd_dlogp": 1,
                                  "graph_reg_bwd_dw": 0}


@pytest.mark.cuda
def test_pinned_tiles_raise_on_the_card(cuda):
    logp, W = _problem(64, 8)
    with pytest.raises(ValueError, match="fixed block shapes"):
        ops.graph_regularizer_fused(logp.to(cuda), W.to(cuda), 1.0, 0.0,
                                    tiles=TileSpec(bi=64))
