"""The port's cross-attention (XATTN) and modality front end against the
JAX package, on the CPU: ``init_cross_attention``, ``cross_kv``,
``cross_attention_block`` and the XATTN decode, and the VLM stack
(llama-3.2-vision-90b) with its ``modality_proj``.

The reference initialises the XATTN gate to 0, and tanh(0)·out = 0, so
an untouched comparison never exercises the cross-attention: every test
here sets the gate to a seeded non-zero value in both packages.  The
cross-attention runs ``chunked_attention`` without a causal mask, every
query at position 0 and the keys at ``arange(M)``; a ragged M (37, and
the reduced config's 16) leaves the last kv tile padded and masked.
Stack level: the reduced config with (B, modality_tokens, modality_dim)
embeddings through ``forward``, ``lm_loss`` (``batch["modality_embeds"]``)
and its gradients, ``prefill`` and every cache leaf (the XATTN layers'
memory k and v, positions ``arange(M)``), and 4 decode steps
(``lm_family_parity``).

Tolerances: float32 atol 1e-4 (``tests/test_torch_lm.py``'s); gradient
leaves within 1e-3 of their largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_family_parity as fam  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.models.layers.attention import KVCache  # noqa: E402
from repro_torch.serve import serve_lm  # noqa: E402

ARCH = "llama-3.2-vision-90b"
D, H, KV, HD = 64, 4, 2, 16


@pytest.fixture(scope="module")
def family():
    run = fam.stack_run(ARCH)
    run["loss"] = fam.lm_loss_run(run)
    return run


def test_forward_matches(family):
    fam.check_forward(family)


def test_prefill_logits_and_caches_match(family):
    """The XATTN caches hold the projected memory at its M slots."""
    fam.check_prefill_and_cache(family)
    cfg = family["cfg_t"]
    leaves = dict(family["cache"][1])
    xattn = cfg.block_pattern.index("xattn")
    assert leaves[f"/layers/{xattn}/KVCache.k"].shape[2] == (
        cfg.modality_tokens)


def test_decode_steps_match(family):
    fam.check_decode(family)


def test_lm_loss_and_grads_match(family):
    """``lm_loss`` passes ``batch["modality_embeds"]`` to ``forward``; the
    gradients reach ``modality_proj`` and every gate."""
    fam.check_lm_loss(family["loss"])


# ------------------------------------------------------------- layer level
@pytest.fixture(scope="module")
def layer():
    p_j = jax.device_get(jattn.init_cross_attention(
        jax.random.PRNGKey(4), D, H, KV, HD, dtype=jnp.float32))
    assert float(p_j["gate"]) == 0.0
    p_j["gate"] = np.float32(0.6)
    return p_j, to_torch(p_j)


def _xm(T, M, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, T, D)).astype(np.float32),
            rng.normal(size=(2, M, D)).astype(np.float32))


@pytest.mark.parametrize("T,M", [(9, 37), (5, 16)])
def test_cross_attention_block_and_grads_match(layer, T, M):
    p_j, p_t = layer
    x, mem = _xm(T, M, seed=M)
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(p, xx, mm):
        mk, mv = jattn.cross_kv(p, mm)
        return jattn.cross_attention_block(p, xx, mk, mv)

    out_j, vjp = jax.vjp(jf, p_j, jnp.asarray(x), jnp.asarray(mem))
    g_pj, g_xj, g_mj = vjp(jnp.asarray(r))
    names = sorted(p_t)
    leaves = [p_t[n].clone().requires_grad_(True) for n in names]
    p = dict(zip(names, leaves))
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    mk, mv = attn.cross_kv(p, mt)
    assert mk.shape == (2, M, KV, HD)
    out_t = attn.cross_attention_block(p, xt, mk, mv)
    grads = torch.autograd.grad(out_t, leaves + [xt, mt],
                                torch.from_numpy(r))
    fam.close(out_t.detach().numpy(), out_j)
    fam.check_grads(list(grads), [g_pj[n] for n in names] + [g_xj, g_mj],
                    names + ["x", "mem"])
    assert float(grads[names.index("gate")]) != 0.0


def test_gate_at_zero_gives_zero(layer):
    """The reference's init: tanh(0)·out is exactly 0 in both."""
    p_j, p_t = layer
    x, mem = _xm(4, 16)
    p_t = dict(p_t, gate=torch.zeros(()))
    mk, mv = attn.cross_kv(p_t, torch.from_numpy(mem))
    assert not attn.cross_attention_block(p_t, torch.from_numpy(x), mk,
                                          mv).any()
    fresh = attn.init_cross_attention(torch.Generator().manual_seed(0), D, H,
                                      KV, HD)
    assert fresh["gate"].dtype == torch.float32 and float(fresh["gate"]) == 0
    assert "bq" not in fresh


def test_cross_decode_matches_the_reference(layer):
    """One token against a memory cache: the query at int32 max − 1, as the
    reference's ``_decode_layer`` places it."""
    p_j, p_t = layer
    x, mem = _xm(1, 21, seed=3)
    mk, mv = jattn.cross_kv(p_j, jnp.asarray(mem))
    valid = np.ones((2, 21), bool)
    valid[1, 15:] = False
    positions = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21))
    y = jattn.decode_attention(
        jnp.einsum("btd,dhk->bthk", jnp.asarray(x), p_j["wq"]), mk, mv,
        jnp.asarray(positions), jnp.asarray(valid),
        jnp.full((2,), jnp.iinfo(jnp.int32).max - 1, jnp.int32), window=None)
    want = (jnp.tanh(p_j["gate"]) * jattn.out_proj(p_j, y).astype(
        jnp.float32)).astype(jnp.float32)
    cache = KVCache(k=torch.from_numpy(np.array(mk)),
                    v=torch.from_numpy(np.array(mv)),
                    positions=torch.from_numpy(positions.copy()),
                    valid=torch.from_numpy(valid))
    got = attn.cross_decode(p_t, torch.from_numpy(x), cache)
    fam.close(got.numpy(), want)


def test_bf16_embeddings_into_float32_params_promote_as_the_reference():
    """The reference's launcher feeds bfloat16 embeddings; against float32
    params the projection runs in float32 in both packages."""
    cfg_j, cfg_t, params_j = fam.reference_params(ARCH, seed=2)
    toks = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    mem = fam.modality(cfg_j, 2, seed=4)
    want = jtf.forward(params_j, cfg_j, jnp.asarray(toks),
                       modality_embeds=jnp.asarray(mem, jnp.bfloat16))
    got = tf.forward(to_torch(params_j), cfg_t,
                     torch.from_numpy(toks).long(),
                     modality_embeds=torch.from_numpy(mem).bfloat16())
    fam.close(got["hidden"].detach().numpy(), want["hidden"])


def test_init_cache_holds_the_modality_slots_and_prefill_no_k11_on_xattn():
    """``init_cache`` gives each XATTN layer ``modality_tokens`` slots; the
    prefill launches no kernel on the CPU (K11's plain version runs the
    causal layers, ``chunked_attention`` the cross layers)."""
    cfg_j, cfg_t, params_j = fam.reference_params(ARCH)
    want = jax.device_get(jtf.init_cache(cfg_j, 2, 11))
    got = tf.init_cache(cfg_t, 2, 11)
    for a, b in fam.same_tree(fam.flat(got), fam.flat(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    xattn = got["layers"][cfg_t.block_pattern.index("xattn")]
    assert xattn.k.shape[2] == cfg_t.modality_tokens
    gr.reset_launch_counts()
    toks = torch.zeros((2, 5), dtype=torch.long)
    mem = torch.from_numpy(fam.modality(cfg_t, 2))
    _, cache = tf.prefill(to_torch(params_j), cfg_t, toks,
                          modality_embeds=mem, cache_len=8)
    assert not any(gr.launch_counts().values())
    xattn = cache["layers"][cfg_t.block_pattern.index("xattn")]
    assert torch.equal(xattn.positions[0, 0],
                       torch.arange(cfg_t.modality_tokens,
                                    dtype=torch.int32))
    assert bool(xattn.valid.all())


def test_serve_lm_draws_modality_embeddings_on_the_cpu(capsys):
    stats = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                           "--batch", "2", "--prompt-len", "9", "--steps",
                           "3"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke" in out and "tok/s" in out
    assert stats["prefill_ms"] > 0 and stats["tok_per_s"] > 0
    cfg = fam.get_config(ARCH).reduced()
    mem = serve_lm.make_modality(cfg, 3, seed=0, device=torch.device("cpu"))
    assert mem.shape == (3, cfg.modality_tokens, cfg.modality_dim)
    assert mem.dtype == getattr(torch, cfg.dtype)
    assert torch.equal(mem, serve_lm.make_modality(
        cfg, 3, seed=0, device=torch.device("cpu")))
    assert serve_lm.make_modality(fam.get_config("qwen2-1.5b"), 3, seed=0,
                                  device=torch.device("cpu")) is None
