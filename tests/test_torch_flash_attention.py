"""K11 (attention forward) of the port against the JAX package, on the CPU.

On CPU tensors ``ops.flash_attention_gqa`` runs the kernel's plain version
(``ref.flash_attention_ref`` over the key tiles of the route the card
would take: 128 keys for bfloat16 at head dim 64, 112 or 128, 64
otherwise).
The same numpy inputs go through the reference's Pallas kernel in
interpret mode (``flash_attention_gqa_pallas``,
``flash_attention_fwd_pallas``) and its O(T²) oracle
``reference_attention``.

Tolerances: float32 atol 3e-5, the reference test's own
(``tests/test_kernels.py``).  bfloat16 against the Pallas kernel on the
same key tiles: |Δ| ≤ 2^-8·max|want| + 2^-7·|want|; both round p and the
output to bfloat16 at the same points, but sum in float32 in other
orders, so a rounding may fall to the other side (one bf16 ulp of the
output's scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd_pallas, flash_attention_gqa_pallas)
from repro.models.layers.attention import \
    reference_attention as jax_reference_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.layers.attention import \
    reference_attention  # noqa: E402

F32_ATOL = 3e-5


def _qkv(B, Tq, H, KV, hd, Tk=None, seed=0):
    rng = np.random.default_rng(seed + 13 * Tq + hd)
    Tk = Tq if Tk is None else Tk
    return (rng.normal(size=(B, Tq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Tk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Tk, KV, hd)).astype(np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return ops.flash_attention_gqa(*args, **kw).float().numpy()


def _bf16_close(got, want):
    tol = 2.0 ** -8 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("B,T,H,KV,hd,bq,bk",
                         [(2, 64, 4, 2, 32, 16, 16),
                          (1, 100, 4, 4, 16, 32, 32),
                          (2, 48, 8, 2, 64, 16, 8),
                          (1, 100, 12, 2, 128, 64, 64),
                          (1, 100, 4, 4, 64, 32, 32),
                          (2, 70, 6, 2, 128, 32, 64)])
def test_matches_pallas_gqa_kernel(B, T, H, KV, hd, bq, bk):
    """The three shapes of the reference's kernel test, a ragged T=100
    at qwen2's head layout (12 query heads on 2 KV heads, hd 128), and
    the groups of the four configurations served whole: H/KV 1 at hd 64
    (qwen1.5-0.5b, musicgen-large) and 3 at hd 128 (phi4-mini-3.8b),
    ragged T."""
    q, k, v = _qkv(B, T, H, KV, hd)
    want = np.asarray(flash_attention_gqa_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, bq=bq,
        bk=bk, interpret=True))
    np.testing.assert_allclose(_port(q, k, v), want, atol=F32_ATOL)


def test_matches_pallas_kernel_with_q_offset():
    """Tq < Tk: query row t sits at position Tk − Tq + t (heads folded into
    the batch, as ``flash_attention_fwd_pallas`` takes them)."""
    BH, Tq, Tk, hd = 6, 40, 100, 32
    q, k, v = _qkv(BH, Tq, 1, 1, hd, Tk=Tk)
    want = np.asarray(flash_attention_fwd_pallas(
        jnp.asarray(q[:, :, 0]), jnp.asarray(k[:, :, 0]),
        jnp.asarray(v[:, :, 0]), causal=True, bq=16, bk=20, interpret=True))
    np.testing.assert_allclose(_port(q, k, v)[:, :, 0], want, atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(100, 100), (37, 100)])
def test_matches_reference_attention(causal, Tq, Tk):
    """Against the O(T²) oracle, causal and not, ragged (the kernel masks
    keys past Tk by bounds), and the port's copy of the oracle too."""
    q, k, v = _qkv(2, Tq, 8, 2, 64, Tk=Tk)
    qpos = jnp.arange(Tk - Tq, Tk)
    kpos = jnp.arange(Tk)
    want = np.asarray(jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qpos, kpos,
        jnp.ones(Tk, bool), causal=causal, window=None))
    np.testing.assert_allclose(_port(q, k, v, causal=causal), want,
                               atol=F32_ATOL)
    mine = reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.arange(Tk - Tq, Tk), torch.arange(Tk),
        torch.ones(Tk, dtype=torch.bool), causal=causal, window=None)
    np.testing.assert_allclose(mine.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("B,T,H,KV,hd", [(2, 64, 4, 2, 32),
                                         (1, 130, 12, 2, 128),
                                         (2, 200, 8, 2, 64),
                                         (1, 130, 4, 4, 64),
                                         (1, 200, 6, 2, 128)])
def test_bf16_matches_pallas_kernel_on_the_same_tiles(B, T, H, KV, hd):
    """Both routes' key tiles: 64 keys (FMA route, hd 32) and 128 keys
    (tensor-core route, hd 64 and 128) in the Pallas kernel too; groups
    H/KV 1 at hd 64 and 3 at hd 128, ragged T (the tensor-core route's
    new head layouts on the card)."""
    q, k, v = _qkv(B, T, H, KV, hd, seed=1)
    bk = fa.block_k(torch.bfloat16, hd)
    assert bk == (128 if hd >= 64 else 64)
    want = np.asarray(flash_attention_gqa_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        bq=64, bk=bk, interpret=True)).astype(np.float32)
    got = _port(q, k, v, dtype=torch.bfloat16)
    _bf16_close(got, want)
    # Output in q's dtype, p in v's: far from the float32 result.
    assert np.abs(got - _port(q, k, v)).max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,KV", [(2, 100, 100, 8, 2),
                                         (1, 40, 130, 16, 2),
                                         (1, 130, 300, 8, 2),
                                         (1, 200, 200, 4, 1)])
def test_head_dim_112_matches_pallas_kernel(dtype, B, Tq, Tk, H, KV):
    """kimi-k2's head dim (7168 / 64 = 112): bfloat16 on the tensor-core
    route's 128-key tiles, float32 on the FMA route's 64-key tiles;
    ragged (T not a multiple of 128) and with Tq < Tk, against the
    reference's Pallas kernel in interpret mode on the same tiles (heads
    folded into the batch, as ``flash_attention_fwd_pallas`` takes
    them)."""
    want_route = "wgmma" if dtype == torch.bfloat16 else "fma"
    bk = {"wgmma": 128, "fma": 64}[want_route]
    assert fa.route(dtype, 112) == want_route
    assert fa.block_k(dtype, 112) == bk
    q, k, v = _qkv(B, Tq, H, KV, 112, Tk=Tk, seed=4)
    G = H // KV

    def fold(a, rep):
        a = np.repeat(a.transpose(0, 2, 1, 3), rep, axis=1)
        return jnp.asarray(a.reshape(-1, a.shape[2], 112),
                           jnp.float32 if dtype == torch.float32
                           else jnp.bfloat16)

    want = np.asarray(flash_attention_fwd_pallas(
        fold(q, 1), fold(k, G), fold(v, G), causal=True, bq=64, bk=bk,
        interpret=True)).astype(np.float32)
    want = want.reshape(B, H, Tq, 112).transpose(0, 2, 1, 3)
    got = _port(q, k, v, dtype=dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 112),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 112),
                                      (torch.float32, 128)])
def test_cpu_path_walks_the_routes_key_tiles(dtype, hd):
    """The CPU path is the plain version on ``block_k(dtype, hd)``, bit for
    bit; in bfloat16 another tile size rounds p elsewhere."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(1, 300, 4, 2, hd, seed=3))
    got = ops.flash_attention_gqa(q, k, v)
    bk = fa.block_k(dtype, hd)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, block_k=bk))
    if dtype == torch.bfloat16:
        other = ref.flash_attention_ref(q, k, v, block_k=192 - bk)
        assert not torch.equal(got, other)


def test_route_and_block_k():
    for hd in (64, 112, 128):
        assert fa.route(torch.bfloat16, hd) == "wgmma"
        assert fa.block_k(torch.bfloat16, hd) == 128
    for dtype, hd in ((torch.bfloat16, 32), (torch.bfloat16, 16),
                      (torch.float32, 128), (torch.float32, 16),
                      (torch.float32, 112)):
        assert fa.route(dtype, hd) == "fma"
        assert fa.block_k(dtype, hd) == 64


@pytest.mark.parametrize("dtype,hd,err", [(torch.float16, 128, TypeError),
                                          (torch.float64, 64, TypeError),
                                          (torch.bfloat16, 48, ValueError),
                                          (torch.float32, 256, ValueError)])
def test_route_and_block_k_refuse_what_the_kernel_does_not_take(dtype, hd,
                                                                err):
    with pytest.raises(err):
        fa.route(dtype, hd)
    with pytest.raises(err):
        fa.block_k(dtype, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk", [(200, 200), (70, 200)])
def test_causal_skip_is_exact(dtype, Tq, Tk):
    """Stopping at the diagonal tile changes no bit: the tiles past it have
    p = 0 and α = 1."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(1, Tq, 4, 2, 32, Tk=Tk, seed=2))
    for bk in (64, 128):   # both routes' key tiles
        skip = ref.flash_attention_ref(q, k, v, causal=True, block_k=bk,
                                       causal_skip=True)
        full = ref.flash_attention_ref(q, k, v, causal=True, block_k=bk,
                                       causal_skip=False)
        assert torch.equal(skip, full)


def test_scale_is_rounded_to_q_dtype():
    """hd^-0.5 is rounded to bfloat16 before the product, as the
    reference's weakly typed scalar is (hd = 128: not a power of two)."""
    q = torch.ones(1, 1, 1, 128, dtype=torch.bfloat16)
    want = np.asarray(jnp.ones((1,), jnp.bfloat16) * (128 ** -0.5))
    assert float(ref.scale_queries(q).flatten()[0]) == float(want[0])


def test_refusals_and_forward_only_entry():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 32))
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.flash_attention_gqa(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="head dim 48"):
        ops.flash_attention_gqa(torch.zeros(1, 4, 2, 48),
                                torch.zeros(1, 4, 1, 48),
                                torch.zeros(1, 4, 1, 48))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention_gqa(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="Tq <= Tk"):
        ops.flash_attention_gqa(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError, match="one device"):
        ops.flash_attention_gqa(q, k.to("meta"), v)
    gr.reset_launch_counts()
    ops.flash_attention_gqa(q, k, v)
    assert gr.launch_counts()["flash_attention"] == 0
