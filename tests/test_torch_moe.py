"""The port's MoE layer (``models/layers/moe.py``) and the MoE stacks
(mixtral-8x7b, and kimi-k2-1t-a32b with its dense first block) against the
JAX package, on the CPU.

Layer level: the same numpy params (the reference's ``init_moe``) and
inputs through both ``apply_moe``: the router's top-k experts and the
capacity keep mask are compared exactly before any value (the reference's
as its own code computes them: ``lax.top_k`` of the softmax, the exclusive
cumsum of the assignment one-hot), at G = 64 dispatch groups (B·T = 64, one
token a group) and G = 1 (B·T = 40, which 64 does not divide); then the
outputs, the Switch loss and the gradients.  Stack level: each config's
``reduced()`` through ``forward`` and ``moe_aux``, ``lm_loss`` and its
gradients, ``prefill`` and every cache leaf (``cache["first"]``
unstacked), 4 decode steps and greedy tokens (``lm_family_parity``).

Tolerances: float32 atol 1e-4; gradient leaves within 1e-3 of their
largest |value|; bfloat16 mean |Δ| / std < 3e-2 (``tests/test_torch_lm.py``'s
rules).
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
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core.ssl_loss import tree_leaves  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.models.layers.attention import KVCache  # noqa: E402
from repro_torch.serve import serve_lm  # noqa: E402

ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
D, F, E, TOP = 32, 48, 4, 2


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    run = fam.stack_run(request.param)
    run["loss"] = fam.lm_loss_run(run)
    return run


def test_forward_and_moe_aux_match(family):
    fam.check_forward(family)
    assert float(family["fwd_t"]["moe_aux"]) > 0


def test_prefill_logits_and_caches_match(family):
    fam.check_prefill_and_cache(family)


def test_decode_steps_match(family):
    fam.check_decode(family)


def test_greedy_tokens_equal(family):
    np.testing.assert_array_equal(*family["greedy"][::-1])


def test_lm_loss_and_grads_match(family):
    """The loss carries 0.01·moe_aux, now non-zero."""
    fam.check_lm_loss(family["loss"])
    assert float(family["loss"]["met_t"]["loss/moe_aux"]) > 0


# ------------------------------------------------------------- layer level
@pytest.fixture(scope="module")
def layer():
    p_j = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(5), D, F, E,
                                       "swiglu"))
    return p_j, to_torch(p_j)


def _reference_routing(p_j, xf, G, cap):
    """The reference's top-k experts and keep mask, by its own lines
    (``apply_moe`` and ``_dispatch_one_group``)."""
    probs = jax.nn.softmax(jnp.asarray(xf) @ p_j["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, TOP)
    e = top_e.reshape(G, -1)
    oh = jax.nn.one_hot(e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=2)
    return np.asarray(top_e), np.asarray(pos < cap)


@pytest.mark.parametrize("B,T,groups", [(4, 16, 64), (2, 20, 1),
                                        (1, 7, 1)])
def test_routing_keep_mask_outputs_and_grads_match(layer, B, T, groups,
                                                  monkeypatch):
    """G = 64 at B·T = 64 (one token a group, cap 1) and G = 1 at B·T = 40
    and 7 (64 divides neither); ``apply_moe``'s own experts and keep mask
    are read by wrapping ``moe.slots``."""
    p_j, p_t = layer
    x = np.random.default_rng(B * T).normal(size=(B, T, D)).astype(
        np.float32)
    N = B * T
    G, cap = moe.groups_and_capacity(N, TOP, E, 1.25, 64)
    assert G == groups
    want_e, want_keep = _reference_routing(p_j, x.reshape(N, D), G, cap)
    _, _, top_e = moe.route(p_t, torch.from_numpy(x).reshape(N, D), TOP)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    _, keep = moe.slots(top_e.reshape(G, -1), E, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)

    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        return jmoe.apply_moe(p, xx, top_k=TOP, capacity_factor=1.25,
                              activation="swiglu", dispatch_groups=64)

    (y_j, aux_j), vjp = jax.vjp(jf, p_j, jnp.asarray(x))
    g_pj, g_xj = vjp((jnp.asarray(r), jnp.float32(0.7)))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(p_t)]
    xt = torch.from_numpy(x).requires_grad_(True)
    seen, slots = [], moe.slots

    def recording(top_e, n_experts, cap):
        out = slots(top_e, n_experts, cap)
        seen.append((top_e, out[1]))
        return out

    monkeypatch.setattr(moe, "slots", recording)
    y_t, aux_t = moe.apply_moe(dict(zip(sorted(p_t), leaves)), xt,
                               top_k=TOP, capacity_factor=1.25,
                               activation="swiglu", dispatch_groups=64)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0][0].reshape(N, TOP).numpy(), want_e)
    np.testing.assert_array_equal(seen[0][1].numpy(), want_keep)
    fam.close(y_t.detach().numpy(), y_j)
    fam.close(aux_t.detach().numpy(), aux_j)
    grads = torch.autograd.grad(
        (y_t * torch.from_numpy(r)).sum() + 0.7 * aux_t, leaves + [xt])
    fam.check_grads(list(grads), jax.tree.leaves(g_pj) + [g_xj],
                    sorted(p_t) + ["x"])


def test_capacity_rounds_half_to_even_and_drops_at_decode():
    """``int(max(1, round(n_g·k/E·cf)))`` with Python's round: 2.5 -> 2;
    mixtral's decode (B = 4 tokens, E = 8, k = 2) has G = 1 and cap 1
    (round(1.25)), kimi's (E = 384, k = 8) cap 1 (the floor)."""
    assert moe.groups_and_capacity(8, 2, 8, 1.25, 64) == (1, 2)
    assert moe.groups_and_capacity(4, 2, 8, 1.25, 64) == (1, 1)
    assert moe.groups_and_capacity(4, 8, 384, 1.25, 64) == (1, 1)
    assert moe.groups_and_capacity(8192, 2, 8, 1.25, 64) == (64, 40)
    assert moe.groups_and_capacity(8192, 8, 384, 1.25, 64) == (64, 3)
    assert moe.groups_and_capacity(40, 2, 4, 1.25, 64) == (1, 25)
    assert moe.groups_and_capacity(64, 2, 4, 1.25, 0) == (1, 40)


def test_ties_go_to_the_lower_expert_and_overflow_is_dropped(layer):
    """A zero router gives every expert the same probability: the reference's
    ``lax.top_k`` picks experts 0 and 1 for every token, so each expert's
    capacity fills in token order and the rest is dropped; the port's
    stable sort picks the same, and the outputs agree."""
    p_j, p_t = layer
    p_j = dict(p_j, router=np.zeros_like(p_j["router"]))
    p_t = dict(p_t, router=torch.zeros_like(p_t["router"]))
    x = np.random.default_rng(2).normal(size=(1, 10, D)).astype(np.float32)
    _, top_w, top_e = moe.route(p_t, torch.from_numpy(x[0]), TOP)
    assert (top_e == torch.tensor([0, 1])).all()
    assert torch.equal(top_w, torch.full_like(top_w, 0.5))
    G, cap = moe.groups_and_capacity(10, TOP, E, 1.25, 0)
    _, keep = moe.slots(top_e.reshape(1, -1), E, cap)
    assert keep.reshape(10, TOP)[:cap].all()
    assert not keep.reshape(10, TOP)[cap:].any()
    y_j, _ = jmoe.apply_moe(p_j, jnp.asarray(x), top_k=TOP,
                            capacity_factor=1.25, activation="swiglu")
    y_t, _ = moe.apply_moe(p_t, torch.from_numpy(x), top_k=TOP,
                           capacity_factor=1.25, activation="swiglu")
    fam.close(y_t.numpy(), y_j)
    assert not y_t[0, cap:].any()


def test_bf16_stack_matches():
    """mixtral reduced in bfloat16: prefill logits and one decode step at
    mean |Δ| / std < 3e-2 (the router in float32 in both)."""
    arch = "mixtral-8x7b"
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16")
    cfg_t = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params_j = jtf.init_params(cfg_j, jax.random.PRNGKey(2))
    params_t = to_torch(jax.device_get(params_j))
    assert params_t["superblocks"][0]["moe"]["router"].dtype == torch.float32
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    out_j, cache_j = jtf.prefill(params_j, cfg_j, jnp.asarray(toks[:, :-1]),
                                 cache_len=36)
    out_t, cache_t = tf.prefill(params_t, cfg_t,
                                torch.from_numpy(toks[:, :-1]).long(),
                                cache_len=36)
    assert out_t["logits"].dtype == torch.bfloat16
    assert fam.mean_rel(out_t["logits"].float(), out_j["logits"]) < 3e-2
    pos = np.full((2,), 32, np.int32)
    step_j, _ = jtf.decode_step(params_j, cfg_j, cache_j,
                                jnp.asarray(toks[:, -1:]), jnp.asarray(pos))
    step_t, _ = tf.decode_step(params_t, cfg_t, cache_t,
                               torch.from_numpy(toks[:, -1:]).long(),
                               torch.from_numpy(pos))
    assert fam.mean_rel(step_t.float(), step_j) < 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_block_and_its_cache_carry_unstacked(dtype):
    """kimi's ``first_block`` and ``cache["first"]`` have no super-block
    axis; ``convert`` carries both, bits and dtypes kept, and the port's
    own init and ``init_cache`` have the reference's tree."""
    arch = "kimi-k2-1t-a32b"
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), dtype=dtype)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    params_j = jax.device_get(jtf.init_params(cfg_j, jax.random.PRNGKey(0)))
    params_t = to_torch(params_j)
    first = params_t["first_block"][0]
    assert "mlp" in first and "moe" not in first
    assert first["attn"]["wq"].shape == params_j["first_block"][0]["attn"][
        "wq"].shape
    for a, b in zip(jax.tree.leaves(to_numpy(params_t)),
                    jax.tree.leaves(params_j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    mine = tf.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert jax.tree.structure(to_numpy(mine)) == jax.tree.structure(params_j)
    cache_j = jax.device_get(jtf.init_cache(cfg_j, 2, 9))
    cache_t = tf.init_cache(cfg_t, 2, 9)
    assert isinstance(cache_t["first"][0], KVCache)
    assert cache_t["first"][0].k.shape == cache_j["first"][0].k.shape
    for a, b in fam.same_tree(fam.flat(cache_t), fam.flat(cache_j)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = to_torch(cache_j)
    assert isinstance(back["first"][0], KVCache)


def test_serve_lm_runs_on_the_cpu(capsys):
    stats = serve_lm.main(["--arch", "mixtral-8x7b", "--device", "cpu",
                           "--reduced", "--batch", "2", "--prompt-len", "9",
                           "--steps", "3"])
    out = capsys.readouterr().out
    assert "mixtral-8x7b-smoke" in out and "tok/s" in out
    assert stats["prefill_ms"] > 0 and stats["tok_per_s"] > 0
