"""The port's Mamba layers (``models/layers/mamba.py``, ``scan_utils.py``)
and the hybrid stack (jamba-1.5-large-398b) against the JAX package, on
the CPU.

Layer level: the same numpy params (the reference's ``init_mamba``,
carried by ``convert.to_torch``) and inputs through both ``mamba_forward``
(T = 256, two 128-step chunks: the reference's checkpointed nested scan,
the port's per-chunk ``torch.utils.checkpoint``; with gradients), the
prefill state at T = 2 (the conv tail left-padded) and ``mamba_decode``.
Stack level: jamba's ``reduced()`` config through ``forward`` (with
``moe_aux``), ``lm_loss`` and its gradients, ``prefill`` and its caches,
4 decode steps and greedy tokens (``lm_family_parity``).

Tolerances: float32 atol 1e-4 (``tests/test_torch_lm.py``'s); gradient
leaves within 1e-3 of their largest |value| (``lm_family_parity``'s
rule); bfloat16 mean |Δ| / std < 3e-2 (``tests/test_torch_lm.py``'s bf16
rule).  ``jax.nn.softplus`` has no threshold and ``F.softplus`` returns x
past 20; the difference, log1p(exp(−x)) < 2.1e-9, is below float32's
resolution at x > 20.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_family_parity as fam  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import mamba as jmamba  # noqa: E402
from repro.models.layers import scan_utils as jscan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core.ssl_loss import tree_leaves  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import mamba  # noqa: E402
from repro_torch.models.layers.scan_utils import chunked_scan  # noqa: E402
from repro_torch.serve import serve_lm  # noqa: E402

ARCH = "jamba-1.5-large-398b"
D, EXPAND, S, K = 32, 2, 8, 4


@pytest.fixture(scope="module")
def family():
    run = fam.stack_run(ARCH)
    run["loss"] = fam.lm_loss_run(run)
    return run


def test_forward_and_moe_aux_match(family):
    fam.check_forward(family)
    assert float(family["fwd_t"]["moe_aux"]) > 0      # MoE on even layers


def test_prefill_logits_and_states_match(family):
    fam.check_prefill_and_cache(family)


def test_decode_steps_match(family):
    fam.check_decode(family)


def test_greedy_tokens_equal(family):
    np.testing.assert_array_equal(*family["greedy"][::-1])


def test_lm_loss_and_grads_match(family):
    fam.check_lm_loss(family["loss"])


# ------------------------------------------------------------- layer level
@pytest.fixture(scope="module")
def layer():
    p_j = jax.device_get(jmamba.init_mamba(
        jax.random.PRNGKey(3), D, expand=EXPAND, d_state=S, d_conv=K))
    return p_j, to_torch(p_j)


def _x(T, seed=0, B=2):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(
        np.float32)


def test_forward_and_grads_match_through_the_chunked_scan(layer):
    """T = 256: two checkpointed 128-step chunks in both packages."""
    p_j, p_t = layer
    x = _x(256)
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p, xx: jmamba.mamba_forward(p, xx), p_j,
                         jnp.asarray(x))
    g_pj, g_xj = vjp(jnp.asarray(r))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(p_t)]
    names = sorted(p_t)
    p = dict(zip(names, leaves))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = mamba.mamba_forward(p, xt)
    grads = torch.autograd.grad(out_t, leaves + [xt], torch.from_numpy(r))
    fam.close(out_t.detach().numpy(), out_j)
    fam.check_grads(list(grads), jax.tree.leaves(g_pj) + [g_xj],
                    names + ["x"])


@pytest.mark.parametrize("T", [2, 3, 9])
def test_prefill_state_and_conv_tail_match(layer, T):
    """T = 2 < d_conv − 1: the conv tail is left-padded with zeros."""
    p_j, p_t = layer
    x = _x(T, seed=T)
    out_j, st_j = jmamba.mamba_forward(p_j, jnp.asarray(x),
                                       return_state=True)
    out_t, st_t = mamba.mamba_forward(p_t, torch.from_numpy(x),
                                      return_state=True)
    fam.close(out_t.numpy(), out_j)
    assert isinstance(st_t, mamba.MambaState)
    assert st_t.conv.shape == (2, K - 1, EXPAND * D)
    assert st_t.ssm.dtype == torch.float32
    fam.close(st_t.conv.numpy(), st_j.conv)
    fam.close(st_t.ssm.numpy(), st_j.ssm)
    if T < K - 1:
        assert not st_t.conv[:, :K - 1 - T].any()


def test_decode_matches_and_continues_the_prefill(layer):
    """One decode step from a random state matches the reference's; and a
    prefill of T − 1 tokens then one decode step gives the prefill of T's
    last output and state."""
    p_j, p_t = layer
    rng = np.random.default_rng(5)
    st = mamba.MambaState(
        conv=torch.from_numpy(rng.normal(size=(2, K - 1, EXPAND * D))
                              .astype(np.float32)),
        ssm=torch.from_numpy(rng.normal(size=(2, EXPAND * D, S))
                             .astype(np.float32)))
    x = _x(1, seed=6)
    out_j, new_j = jmamba.mamba_decode(
        p_j, jnp.asarray(x), fam.JAX_STATES["MambaState"](
            **{f: jnp.asarray(v) for f, v in
               dataclasses.asdict(to_numpy(st)).items()}))
    out_t, new_t = mamba.mamba_decode(p_t, torch.from_numpy(x), st)
    fam.close(out_t.numpy(), out_j)
    fam.close(new_t.conv.numpy(), new_j.conv)
    fam.close(new_t.ssm.numpy(), new_j.ssm)
    xs = torch.from_numpy(_x(7, seed=7))
    full, st_full = mamba.mamba_forward(p_t, xs, return_state=True)
    _, st6 = mamba.mamba_forward(p_t, xs[:, :6], return_state=True)
    last, st7 = mamba.mamba_decode(p_t, xs[:, 6:], st6)
    fam.close(last[:, 0].numpy(), full[:, 6].numpy(), atol=1e-5)
    fam.close(st7.ssm.numpy(), st_full.ssm.numpy(), atol=1e-5)
    fam.close(st7.conv.numpy(), st_full.conv.numpy(), atol=1e-5)


def test_init_matches_the_reference(layer):
    """A_log (within float32 round-off of the logarithm), D and conv_b are
    the reference's; dt_proj_b is softplus⁻¹ of dt in [1e-3, 1e-1]; the
    random leaves have the reference's shapes, dtypes and standard
    deviations (within 10 %)."""
    p_j, _ = layer
    p_t = mamba.init_mamba(torch.Generator().manual_seed(0), D,
                           expand=EXPAND, d_state=S, d_conv=K)
    assert sorted(p_t) == sorted(p_j)
    for name, want in p_j.items():
        got = p_t[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "A_log":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        elif name in ("D", "conv_b"):
            np.testing.assert_array_equal(got, want)
        elif name != "dt_proj_b":
            assert abs(got.std() - want.std()) <= 0.1 * want.std(), name
    dt = np.log1p(np.exp(p_t["dt_proj_b"].numpy()))
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("T,chunk", [(256, 128), (40, 128), (30, 8)])
def test_chunked_scan_matches_the_reference(T, chunk):
    """A scan with a (B, S) carry and two xs: values and gradients equal
    the reference's ``chunked_scan`` (checkpointed chunks when C divides T,
    the plain loop otherwise: T = 30, C = 8)."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (T, 3, 4)).astype(np.float32)
    b = rng.normal(size=(T, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(3, 4)).astype(np.float32)

    def jstep(h, inp):
        h = inp[0] * h + jnp.tanh(inp[1])
        return h, h * h

    def tstep(h, inp):
        h = inp[0] * h + torch.tanh(inp[1])
        return h, h * h

    def jf(h0, a, b):
        h, ys = jscan.chunked_scan(jstep, h0, (a, b), chunk=chunk)
        return jnp.sum(ys) + jnp.sum(h)

    want, gj = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(h0), jnp.asarray(a), jnp.asarray(b))
    args = [torch.from_numpy(v).requires_grad_(True) for v in (h0, a, b)]
    h, ys = chunked_scan(tstep, args[0], (args[1], args[2]), chunk=chunk)
    got = ys.sum() + h.sum()
    gt = torch.autograd.grad(got, args)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for x, y in zip(gt, gj):
        fam.close(x.numpy(), y)
    with torch.no_grad():
        h2, ys2 = chunked_scan(tstep, args[0], (args[1], args[2]),
                               chunk=chunk)
    assert torch.equal(h2, h) and torch.equal(ys2, ys)


def test_bf16_mixer_matches():
    """The Mamba mixer in bfloat16 (``dB = dt·Bm`` rounded to bf16 before
    the float32 state in both packages): the forward and one decode step
    at mean |Δ| / std < 3e-2 of the reference's, and no farther from the
    float32 result than 1.5× the reference's own bf16 error."""
    p_j = jax.device_get(jmamba.init_mamba(
        jax.random.PRNGKey(4), 128, expand=2, d_state=16, d_conv=4,
        dtype=jnp.bfloat16))
    p_t = to_torch(p_j)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p_j)
    x = np.random.default_rng(8).normal(size=(2, 33, 128)).astype(np.float32)
    want, st_j = jmamba.mamba_forward(p_j, jnp.asarray(x[:, :32],
                                                       jnp.bfloat16),
                                      return_state=True)
    got, st_t = mamba.mamba_forward(p_t, torch.from_numpy(x[:, :32])
                                    .bfloat16(), return_state=True)
    assert got.dtype == torch.bfloat16 and st_t.conv.dtype == torch.bfloat16
    assert st_t.ssm.dtype == torch.float32
    f32 = jmamba.mamba_forward(p32, jnp.asarray(x[:, :32]))
    assert fam.mean_rel(got.float(), want) < 3e-2
    assert fam.mean_rel(got.float(), f32) <= 1.5 * fam.mean_rel(want, f32)
    step_j, _ = jmamba.mamba_decode(p_j, jnp.asarray(x[:, 32:], jnp.bfloat16),
                                    st_j)
    step_t, _ = mamba.mamba_decode(p_t, torch.from_numpy(x[:, 32:])
                                   .bfloat16(), st_t)
    assert fam.mean_rel(step_t.float(), step_j) < 3e-2


def test_bf16_stack_is_as_close_to_float32_as_the_reference():
    """jamba reduced in bfloat16 (16 layers: Mamba, attention and MoE):
    its own bf16 round-off is large (mean |Δ| / std ≈ 0.115 of the float32
    forward in the reference), so the two packages' bf16 logits are held
    by their distance to the float32 result (the port's within 1.5× the
    reference's), not to each other."""
    cfg_j = dataclasses.replace(jax_config(ARCH).reduced(), dtype="bfloat16")
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    params_j = jtf.init_params(cfg_j, jax.random.PRNGKey(2))
    params_t = to_torch(jax.device_get(params_j))
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    want = jtf.forward(params_j, cfg_j, jnp.asarray(toks))["logits"]
    got = tf.forward(params_t, cfg_t, torch.from_numpy(toks).long())
    assert got["logits"].dtype == torch.bfloat16
    f32 = jtf.forward(jax.tree.map(lambda a: a.astype(jnp.float32), params_j),
                      dataclasses.replace(cfg_j, dtype="float32"),
                      jnp.asarray(toks))["logits"]
    assert fam.mean_rel(got["logits"].float().detach(), f32) <= (
        1.5 * fam.mean_rel(want, f32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_mamba_states_bit_for_bit(dtype):
    """The reference's MambaState becomes the port's and back, bits and
    dtypes kept (the conv window in the model's dtype, ssm float32)."""
    rng = np.random.default_rng(9)
    st = fam.JAX_STATES["MambaState"](
        conv=jnp.asarray(rng.normal(size=(3, K - 1, 16)), dtype),
        ssm=jnp.asarray(rng.normal(size=(3, 16, S)), jnp.float32))
    st = jax.device_get(st)
    got = to_torch(st)
    assert isinstance(got, mamba.MambaState)
    assert got.conv.dtype == getattr(torch, dtype)
    back = to_numpy(got)
    assert type(back) is mamba.MambaState
    back = fam.JAX_STATES[type(back).__name__](**vars(back))
    for f in ("conv", "ssm"):
        want = np.asarray(getattr(st, f))
        assert getattr(back, f).dtype == want.dtype
        np.testing.assert_array_equal(getattr(back, f).view(np.uint8),
                                      want.view(np.uint8))


def test_serve_lm_runs_on_the_cpu(capsys):
    stats = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                           "--batch", "2", "--prompt-len", "9", "--steps",
                           "3", "--temperature", "0"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke" in out and "tok/s" in out
    assert stats["prefill_ms"] > 0 and stats["tok_per_s"] > 0
