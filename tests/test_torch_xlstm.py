"""The port's xLSTM blocks (``models/layers/xlstm.py``) and
``group_norm_heads``, and the xlstm-125m stack, against the JAX package,
on the CPU.

Layer level: the same numpy params (the reference's ``init_slstm`` /
``init_mlstm``) and inputs through both packages' forwards at T = 256 (two
checkpointed 128-step chunks of ``chunked_scan``; with gradients), the
prefill states at T = 2 (mLSTM's conv tail left-padded) and the decodes.
Stack level: the reduced config (sLSTM, mLSTM, no FFN) through
``forward``, ``lm_loss`` and its gradients, ``prefill`` and every state
leaf, 4 decode steps and greedy tokens (``lm_family_parity``).

Tolerances: float32 atol 1e-4 (``tests/test_torch_lm.py``'s) on outputs;
states, whose matrix memory C grows with T, within 1e-4 of their largest
|value| (at T = 256, |C| reaches ~10); gradient leaves within 1e-3 of
their largest |value| (``lm_family_parity``'s rule).  sLSTM's GeGLU is
``jax.nn.gelu``, the tanh approximation, in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_family_parity as fam  # noqa: E402
from repro.models.layers import common as jcommon  # noqa: E402
from repro.models.layers import xlstm as jxlstm  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.models.layers import xlstm  # noqa: E402
from repro_torch.models.layers.common import group_norm_heads  # noqa: E402
from repro_torch.serve import serve_lm  # noqa: E402

ARCH = "xlstm-125m"
D, H = 32, 4


@pytest.fixture(scope="module")
def family():
    run = fam.stack_run(ARCH)
    run["loss"] = fam.lm_loss_run(run)
    return run


def test_forward_matches(family):
    fam.check_forward(family)
    assert float(family["fwd_t"]["moe_aux"]) == 0.0


def test_prefill_logits_and_states_match(family):
    fam.check_prefill_and_cache(family)


def test_decode_steps_match(family):
    fam.check_decode(family)


def test_greedy_tokens_equal(family):
    np.testing.assert_array_equal(*family["greedy"][::-1])


def test_lm_loss_and_grads_match(family):
    fam.check_lm_loss(family["loss"])


# ------------------------------------------------------------- layer level
BLOCKS = {"slstm": (jxlstm.init_slstm, jxlstm.slstm_forward,
                    jxlstm.slstm_decode, xlstm.slstm_forward,
                    xlstm.slstm_decode),
          "mlstm": (jxlstm.init_mlstm, jxlstm.mlstm_forward,
                    jxlstm.mlstm_decode, xlstm.mlstm_forward,
                    xlstm.mlstm_decode)}


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def block(request):
    init = BLOCKS[request.param][0]
    p_j = jax.device_get(init(jax.random.PRNGKey(6), D, H))
    return (request.param, p_j, to_torch(p_j)) + BLOCKS[request.param][1:]


def _x(T, seed=0):
    return np.random.default_rng(seed).normal(size=(2, T, D)).astype(
        np.float32)


def _close_scaled(got, want):
    want = np.asarray(want, np.float32)
    fam.close(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_forward_state_and_grads_match_through_the_chunked_scan(block):
    """T = 256: two checkpointed 128-step chunks in both packages; the
    final state of the prefill too."""
    kind, p_j, p_t, jfwd, _, tfwd, _ = block
    x = _x(256, seed=len(kind))
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p, xx: jfwd(p, xx), p_j, jnp.asarray(x))
    g_pj, g_xj = vjp(jnp.asarray(r))
    names = sorted(p_t)
    leaves = [p_t[n].clone().requires_grad_(True) for n in names]
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = tfwd(dict(zip(names, leaves)), xt)
    grads = torch.autograd.grad(out_t, leaves + [xt], torch.from_numpy(r))
    fam.close(out_t.detach().numpy(), out_j)
    fam.check_grads(list(grads), [g_pj[n] for n in names] + [g_xj],
                    names + ["x"], zero=("bi",) if kind == "slstm" else ())
    _, st_j = jfwd(p_j, jnp.asarray(x), return_state=True)
    _, st_t = tfwd(p_t, torch.from_numpy(x), return_state=True)
    for f, want in dataclasses.asdict(st_j).items():
        _close_scaled(getattr(st_t, f).numpy(), want)


@pytest.mark.parametrize("T", [2, 5])
def test_short_prefill_state_and_decode_match(block, T):
    """T = 2 < 3: mLSTM's conv tail is left-padded with zeros; one decode
    step from the prefill's state matches the reference's, and continues
    the prefill (a prefill of T + 1 tokens ends in the same state)."""
    kind, p_j, p_t, jfwd, jdec, tfwd, tdec = block
    x = _x(T + 1, seed=T)
    out_j, st_j = jfwd(p_j, jnp.asarray(x[:, :T]), return_state=True)
    out_t, st_t = tfwd(p_t, torch.from_numpy(x[:, :T]), return_state=True)
    fam.close(out_t.numpy(), out_j)
    cls = xlstm.SLSTMState if kind == "slstm" else xlstm.MLSTMState
    assert isinstance(st_t, cls)
    for f, want in dataclasses.asdict(st_j).items():
        got = getattr(st_t, f)
        assert got.shape == want.shape and str(got.dtype)[6:] == str(
            want.dtype), f
        fam.close(got.numpy(), want)
    if kind == "mlstm" and T < 3:
        assert not st_t.conv[:, :3 - T].any()
    y_j, new_j = jdec(p_j, jnp.asarray(x[:, T:]), st_j)
    y_t, new_t = tdec(p_t, torch.from_numpy(x[:, T:]), st_t)
    fam.close(y_t.numpy(), y_j)
    for f, want in dataclasses.asdict(new_j).items():
        fam.close(getattr(new_t, f).numpy(), want)
    full, st_full = tfwd(p_t, torch.from_numpy(x), return_state=True)
    fam.close(y_t[:, 0].numpy(), full[:, T].numpy(), atol=1e-5)
    for f in dataclasses.asdict(st_full):
        fam.close(getattr(new_t, f).numpy(), getattr(st_full, f).numpy(),
                  atol=1e-5)


def test_init_matches_the_reference(block):
    """The reference's leaves, shapes and dtypes (mLSTM's gates float32),
    sLSTM's forget bias 1 and mLSTM's 3, the others 0; random leaves with
    the reference's standard deviation within 10 %."""
    kind, p_j, _, *_ = block
    init = xlstm.init_slstm if kind == "slstm" else xlstm.init_mlstm
    p_t = init(torch.Generator().manual_seed(0), D, H)
    assert sorted(p_t) == sorted(p_j)
    for name, want in p_j.items():
        got = p_t[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if np.all(want == want.flat[0]):
            np.testing.assert_array_equal(got, want)
        else:
            assert abs(got.std() - want.std()) <= 0.1 * want.std(), name


def test_group_norm_heads_matches():
    x = np.random.default_rng(2).normal(3.0, 2.0, (2, 5, 4, 16))
    for dt in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jcommon.group_norm_heads(jnp.asarray(x, dt)),
                          np.float32)
        got = group_norm_heads(torch.from_numpy(x).to(
            torch.float32 if dt == jnp.float32 else torch.bfloat16))
        assert got.dtype == (torch.float32 if dt == jnp.float32
                             else torch.bfloat16)
        tol = 1e-5 if dt == jnp.float32 else 2 ** -7 * np.abs(want).max()
        fam.close(got.float().numpy(), want, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_xlstm_states_bit_for_bit(dtype):
    """The reference's SLSTMState and MLSTMState become the port's and back,
    bits and dtypes kept (mLSTM's conv window in the model's dtype, the
    rest float32)."""
    rng = np.random.default_rng(10)
    states = [
        fam.JAX_STATES["SLSTMState"](*(jnp.asarray(
            rng.normal(size=(3, H, 8)), jnp.float32) for _ in range(4))),
        fam.JAX_STATES["MLSTMState"](
            conv=jnp.asarray(rng.normal(size=(3, 3, 16)), dtype),
            C=jnp.asarray(rng.normal(size=(3, H, 4, 4)), jnp.float32),
            n=jnp.asarray(rng.normal(size=(3, H, 4)), jnp.float32),
            m=jnp.asarray(rng.normal(size=(3, H)), jnp.float32))]
    for st, cls in zip(jax.device_get(states),
                       (xlstm.SLSTMState, xlstm.MLSTMState)):
        got = to_torch(st)
        assert isinstance(got, cls)
        back = to_numpy(got)
        assert type(back) is cls
        back = fam.JAX_STATES[type(back).__name__](**vars(back))
        assert type(back) is type(st)
        for f, want in dataclasses.asdict(st).items():
            want = np.asarray(want)
            assert getattr(back, f).dtype == want.dtype
            np.testing.assert_array_equal(getattr(back, f).view(np.uint8),
                                          want.view(np.uint8))


def test_stacked_states_are_updated_in_place(family):
    """``decode_step`` copies each new state into the stacked tensors of
    the cache it was given (the reference returns new ones)."""
    from repro_torch.models import transformer as tf
    cfg, params = family["cfg_t"], family["params_t"]
    cache = tf.init_cache(cfg, 2, 8)
    stacked = cache["layers"][1]
    tensors = dict(vars(stacked))
    _, out = tf.decode_step(params, cfg, cache,
                            torch.zeros((2, 1), dtype=torch.long),
                            torch.zeros(2, dtype=torch.int32))
    assert out is cache and out["layers"][1] is stacked
    assert all(getattr(stacked, f) is t for f, t in tensors.items())
    assert bool(stacked.C.any()) and bool(stacked.n.any())


def test_serve_lm_runs_on_the_cpu(capsys):
    stats = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                           "--batch", "2", "--prompt-len", "9", "--steps",
                           "3"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke" in out and "tok/s" in out
    assert stats["prefill_ms"] > 0 and stats["tok_per_s"] > 0
