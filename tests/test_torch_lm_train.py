"""The port's LM training path against the JAX package, on the CPU.

Same numpy inputs through both packages at small sizes (2 layers, d_model
128, V 512): ``chunked_attention`` and its backward, ``chunked_ce``, the
transformer's ``forward`` with its SSL head under each ``remat_policy``,
``lm_loss`` with and without the sequence-level graph regularizer,
``lm_train_step`` with AdaGrad, ``abstract_params``, sliding-window
(ATTN_SWA) prefill and decode with ring caches, the token corpus and the
input shapes.  The reference runs its jnp paths (``pairwise="ref"``); the
port runs its plain kernel versions, which is what ``"auto"`` runs on CPU
tensors.

Tolerances: float32 values rtol 1e-5 and gradients rtol 1e-4, each with an
atol of the same fraction of the largest |value| of the compared array
(the two packages sum float32 terms in other orders); scalar losses and
metrics rtol 1e-5 with an atol of 1e-5·max(1, |want|).  bfloat16 outputs:
atol 1e-2·max|want| (about 2.5 bf16 ulps at the top of the range; both
packages take the products in float32 and round at the same points).
Host copies (``data/tokens.py``, ``configs/shapes.py``) bit for bit.
AdaGrad's first step moves a parameter by ±lr wherever |g| ≫ √eps, so a
round-off in a tiny gradient shows at full size in the params: the update
is held on the reference's own gradients, and the gradients apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.ssl_loss import SSLHyper as JHyper  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ATTN_SWA  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.optim import adagrad as jadagrad  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core.ssl_loss import SSLHyper, tree_leaves  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.examples import train_lm_ssl  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

VALUE_RTOL, GRAD_RTOL, BF16_ATOL = 1e-5, 1e-4, 1e-2
HYPER = dict(gamma=0.05, kappa=1e-4, weight_decay=0.0)
LR = 3e-3


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    atol = rtol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_metric(got, want):
    """A scalar loss or metric: rtol 1e-5 with an atol of 1e-5·max(1,
    |want|), as ``tests/test_torch_ssl_step.py`` holds them (the graph term
    is a difference of O(1) sums)."""
    want = float(np.asarray(want))
    np.testing.assert_allclose(float(got), want, rtol=VALUE_RTOL,
                               atol=VALUE_RTOL * max(1.0, abs(want)))


def _leaves_np(tree):
    return [np.asarray(x, np.float64) for x in tree_leaves(to_numpy(tree))]


# ---------------------------------------------------------- host copies
def test_token_corpus_features_and_batches_are_bit_identical():
    toks_j, top_j = jtokens.make_token_corpus(24, 33, 300, n_topics=5, seed=3)
    toks_t, top_t = ttokens.make_token_corpus(24, 33, 300, n_topics=5, seed=3)
    np.testing.assert_array_equal(toks_t, toks_j)
    np.testing.assert_array_equal(top_t, top_j)
    assert toks_t.dtype == toks_j.dtype
    f_j = jtokens.sequence_features(toks_j, 300, dim=16, seed=1)
    f_t = ttokens.sequence_features(toks_t, 300, dim=16, seed=1)
    assert f_t.dtype == f_j.dtype
    np.testing.assert_array_equal(f_t, f_j)
    gen_j = jtokens.lm_batches(toks_j, 5, seed=2)
    gen_t = ttokens.lm_batches(toks_t, 5, seed=2)
    for _ in range(7):                  # past one pass over the corpus
        for a, b in zip(next(gen_t), next(gen_j)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_shapes_and_config_for_shape_match(arch):
    assert list(tshapes.INPUT_SHAPES) == list(jshapes.INPUT_SHAPES)
    assert tshapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    for name, shape in tshapes.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jshapes.INPUT_SHAPES[name])
        got = tshapes.config_for_shape(get_config(arch), shape)
        want = jshapes.config_for_shape(jax_config(arch),
                                        jshapes.INPUT_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------- chunked attention
#: (B, Tq, Tk, H, KV, hd, causal, window, q_block, kv_block, sequential)
ATTN_CASES = {
    "causal-ragged": (2, 37, 37, 4, 2, 16, True, None, 8, 16, True),
    "causal-full-grid": (2, 37, 37, 4, 2, 16, True, None, 8, 16, False),
    "window<T": (2, 37, 37, 4, 2, 16, True, 5, 8, 16, True),
    "window<T-full-grid": (1, 24, 24, 2, 2, 16, True, 7, 8, 8, False),
    "window>T": (2, 40, 40, 4, 1, 16, True, 50, 16, 8, True),
    "non-causal-Tq<Tk": (1, 20, 33, 6, 3, 8, False, None, 16, 8, False),
    "non-causal-window": (1, 21, 21, 4, 4, 8, False, 6, 8, 8, False),
    "gqa-1-tile": (2, 12, 12, 8, 2, 16, True, None, 512, 1024, True),
    "window<T-whole-blocks": (2, 48, 48, 4, 2, 16, True, 20, 16, 8, True),
}


def _attn_inputs(B, Tq, Tk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Tk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Tk, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, Tq, H, hd)).astype(np.float32)
    qp = (np.arange(Tq) + Tk - Tq).astype(np.int32)
    kp = np.arange(Tk).astype(np.int32)
    return q, k, v, do, qp, kp, np.ones(Tk, bool)


def _both_attention(case, dtype):
    B, Tq, Tk, H, KV, hd, causal, window, qb, kb, seq = case
    q, k, v, do, qp, kp, kval = _attn_inputs(B, Tq, Tk, H, KV, hd)
    kw = dict(causal=causal, window=window, q_block=qb, kv_block=kb,
              sequential_positions=seq)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jf(q, k, v):
        return jattn.chunked_attention(q, k, v, jnp.asarray(qp),
                                       jnp.asarray(kp), jnp.asarray(kval),
                                       **kw)

    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    out_j, vjp = jax.vjp(jf, *jin)
    grads_j = vjp(jnp.asarray(do, jdt))
    tin = [to_torch(np.asarray(a)).requires_grad_(True) for a in jin]
    out_t = tattn.chunked_attention(*tin, torch.from_numpy(qp),
                                    torch.from_numpy(kp),
                                    torch.from_numpy(kval), **kw)
    out_t.backward(to_torch(np.asarray(jnp.asarray(do, jdt))))
    return (out_t, [t.grad for t in tin]), (out_j, grads_j)


def _offset_moves(case) -> bool:
    """Whether the reference's padded lengths move row 0's position: its
    tile skipping then differs from the masks (see ``_tri_tile_list``)."""
    B, Tq, Tk, H, KV, hd, causal, window, qb, kb, seq = case
    return seq and (-Tk) % min(kb, Tk) != (-Tq) % min(qb, Tq)


def _oracle(case):
    B, Tq, Tk, H, KV, hd, causal, window, qb, kb, seq = case
    q, k, v, _, qp, kp, kval = _attn_inputs(B, Tq, Tk, H, KV, hd)
    return np.asarray(jattn.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v, qp, kp, kval)), causal=causal,
        window=window))


@pytest.mark.parametrize("case", ATTN_CASES.values(), ids=ATTN_CASES.keys())
def test_chunked_attention_values_and_grads_match(case):
    """Held to the reference's chunked_attention with the same tiles and
    skipping, or, where its padded lengths move the skipping off the masks,
    to its full tile grid (no skipping); and to its O(T²) oracle."""
    want_case = case[:-1] + (False,) if _offset_moves(case) else case
    (out_t, g_t), _ = _both_attention(case, "float32")
    _, (out_j, g_j) = _both_attention(want_case, "float32")
    _close(out_t.detach().numpy(), out_j, VALUE_RTOL)
    for name, a, b in zip("qkv", g_t, g_j):
        assert a.dtype == torch.float32, name
        _close(a.numpy(), b, GRAD_RTOL)
    _close(out_t.detach().numpy(), _oracle(case), 1e-4)


def test_reference_tile_skipping_drops_window_keys_at_ragged_lengths():
    """The reference's fault that the port does not carry over: at Tq = Tk
    = 37 with q blocks of 8 and kv blocks of 16, its tile list sees row 0
    at position 8 and drops the tile that holds rows 16-19's first window
    keys."""
    case = ATTN_CASES["window<T"]
    assert _offset_moves(case)
    (out_t, _), (out_j, _) = _both_attention(case, "float32")
    wrong = np.abs(np.asarray(out_j) - _oracle(case)).max(axis=(0, 2, 3))
    assert list(np.nonzero(wrong > 1e-3)[0]) == [16, 17, 18, 19, 32, 33,
                                                  34, 35]
    _close(out_t.detach().numpy(), _oracle(case), 1e-4)


def test_chunked_attention_bf16_matches():
    case = ATTN_CASES["window<T-whole-blocks"]
    assert not _offset_moves(case)
    (out_t, g_t), (out_j, g_j) = _both_attention(case, "bfloat16")
    assert out_t.dtype == torch.bfloat16
    for got, want in [(out_t.detach(), out_j)] + list(zip(g_t, g_j)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=BF16_ATOL * np.abs(want).max())


def test_tile_list_skips_what_the_masks_empty():
    kw = dict(causal=True, window=None, sequential=True)
    args = (4, 4, 8, 8, 32, 32)
    assert tattn._tri_tile_list(*args, **kw) == jattn._tri_tile_list(
        *args, **kw)
    assert len(tattn._tri_tile_list(*args, **kw)) == 10     # triangle
    kw["window"] = 9
    assert tattn._tri_tile_list(*args, **kw) == jattn._tri_tile_list(
        *args, **kw) == [(0, 0), (1, 0), (1, 1), (2, 1), (2, 2), (3, 2),
                         (3, 3)]
    assert len(tattn._tri_tile_list(*args, causal=True, window=9,
                                    sequential=False)) == 16


# ------------------------------------------------------------ chunked CE
@pytest.mark.parametrize("T,chunk", [(13, 5), (8, 512)])
def test_chunked_ce_value_and_grads_match(T, chunk):
    rng = np.random.default_rng(T)
    B, d, V = 3, 16, 40
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    head = rng.normal(size=(d, V)).astype(np.float32)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    want, (gx_j, gh_j) = jax.value_and_grad(
        lambda x, h: jstep.chunked_ce(x, h, jnp.asarray(tgt),
                                      jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head).requires_grad_(True)
    got = tstep.chunked_ce(xt, ht, torch.from_numpy(tgt).long(),
                           torch.from_numpy(mask), chunk=chunk)
    got.backward()
    _close(got.detach().numpy(), want, VALUE_RTOL)
    _close(xt.grad.numpy(), gx_j, GRAD_RTOL)
    _close(ht.grad.numpy(), gh_j, GRAD_RTOL)


# ------------------------------------------------- transformer forward
def _cfgs(**over):
    over = {"n_layers": 2, **over}
    return (dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **over),
            dataclasses.replace(get_config("qwen2-1.5b").reduced(), **over))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs()
    params_j = jax.device_get(jtf.init_params(cfg_j, jax.random.PRNGKey(7)))
    # Non-zero biases and norm scales, so their gradients are exercised.
    rng = np.random.default_rng(7)
    params_j = jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim and a.shape[-1] in (32, 128) and np.all(a == a.flat[0])
        else a, params_j)
    return cfg_j, cfg_t, params_j


def _lm_batch(cfg, G, b, T, seed=0):
    rng = np.random.default_rng(seed)
    B = G * b
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    W = rng.random((G, b, b)) * (rng.random((G, b, b)) < 0.5)
    W = (W + W.swapaxes(1, 2)).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": (rng.random((B, T)) < 0.9).astype(np.float32),
            "W": W,
            "seq_labels": rng.integers(0, cfg.vocab_size,
                                       (G, b)).astype(np.int32),
            "seq_label_mask": (rng.random((G, b)) < 0.5).astype(np.float32)}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "targets"):
        out[k] = out[k].long()
    return out


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_forward_outputs_and_grads_match_under_remat_policy(model, policy):
    cfg_j, cfg_t, params_j = model
    cfg_j = dataclasses.replace(cfg_j, remat_policy=policy)
    cfg_t = dataclasses.replace(cfg_t, remat_policy=policy)
    toks = _lm_batch(cfg_j, 1, 3, 20)["tokens"]
    r = np.random.default_rng(1).normal(
        size=(3, cfg_j.vocab_size)).astype(np.float32)

    def jloss(p):
        out = jtf.forward(p, cfg_j, jnp.asarray(toks))
        return jnp.sum(out["pooled_logits"] * r) + jnp.mean(
            out["logits"] ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params_j)
    params_t = to_torch(params_j)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params_t)]
    out_t = tf.forward(params_t, cfg_t, torch.from_numpy(toks).long())
    loss = (torch.sum(out_t["pooled_logits"] * torch.from_numpy(r))
            + torch.mean(out_t["logits"] ** 2))
    grads_t = torch.autograd.grad(loss, leaves)
    for key in ("logits", "hidden", "pooled_logits", "moe_aux"):
        _close(out_t[key].detach().numpy(), out_j[key], VALUE_RTOL)
    assert out_t["moe_aux"].dtype == torch.float32
    for a, b in zip(grads_t, jax.tree.leaves(grads_j)):
        _close(a.numpy(), b, GRAD_RTOL)
    without = tf.forward(params_t, cfg_t, torch.from_numpy(toks).long(),
                         with_logits=False)
    assert without["logits"] is None
    _close(without["pooled_logits"].detach().numpy(),
           out_j["pooled_logits"], VALUE_RTOL)


@pytest.mark.parametrize("param_dtype", [None, "bfloat16"])
def test_abstract_params_match_eval_shape(param_dtype):
    for arch in ("qwen2-1.5b", "yi-9b"):
        want = jtf.abstract_params(jax_config(arch), param_dtype=param_dtype)
        got = tf.abstract_params(get_config(arch), param_dtype=param_dtype)
        flat_w, tree_w = jax.tree.flatten(want)
        flat_g = tree_leaves(got)
        assert len(flat_g) == len(flat_w)
        assert jax.tree.structure(jax.tree.map(
            lambda t: 0, got)) == jax.tree.structure(jax.tree.map(
                lambda s: 0, want))
        for g, w in zip(flat_g, flat_w):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


# ----------------------------------------------------------- LM loss/step
@pytest.mark.parametrize("ssl,G,pairwise", [
    (False, 1, None), (True, 1, "auto"), (True, 2, "auto"), (True, 2, None)])
def test_lm_loss_metrics_and_grads_match(model, ssl, G, pairwise):
    cfg_j, cfg_t, params_j = model
    batch = _lm_batch(cfg_j, G, 4, 12, seed=G)
    if not ssl:
        batch = {k: batch[k] for k in ("tokens", "targets", "loss_mask")}
    hyper_j = JHyper(**HYPER) if ssl else None
    (loss_j, met_j), grads_j = jax.value_and_grad(
        jstep.lm_loss, has_aux=True)(
        params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
        hyper_j, pairwise="ref" if ssl else None)
    gr.reset_launch_counts()
    grads_t, met_t = tstep.lm_grads(
        to_torch(params_j), _torch_batch(batch), cfg=cfg_t,
        hyper=SSLHyper(**HYPER) if ssl else None, pairwise=pairwise)
    assert not any(gr.launch_counts().values())      # plain versions
    assert set(met_t) == set(met_j)
    if ssl:
        assert {"ssl/graph", "ssl/supervised", "ssl/labeled",
                "ssl/l2"} <= set(met_t)
    for key in met_j:
        _close_metric(met_t[key], met_j[key])
    _close_metric(met_t["loss/total"], loss_j)
    for a, b in zip(_leaves_np(grads_t), jax.tree.leaves(grads_j)):
        _close(a, b, GRAD_RTOL)


def test_lm_train_step_metrics_grads_and_adagrad_state_match(model):
    cfg_j, cfg_t, params_j = model
    batch = _lm_batch(cfg_j, 1, 6, 16, seed=11)
    opt_j = jadagrad()
    new_j, state_j, met_j = jstep.lm_train_step(
        params_j, opt_j.init(params_j),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg=cfg_j,
        hyper=JHyper(**HYPER), opt=opt_j, lr=jnp.float32(LR),
        pairwise="ref")
    grads_j = jax.grad(lambda p: jstep.lm_loss(
        p, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
        JHyper(**HYPER), pairwise="ref")[0])(params_j)
    grads_t, _ = tstep.lm_grads(to_torch(params_j), _torch_batch(batch),
                                cfg=cfg_t, hyper=SSLHyper(**HYPER),
                                pairwise="auto")
    for a, b in zip(_leaves_np(grads_t), jax.tree.leaves(grads_j)):
        _close(a, b, GRAD_RTOL)
    opt = adagrad()
    params_t = to_torch(params_j)
    state_t = opt.init(params_t)
    out_p, out_s, met_t = tstep.lm_train_step(
        params_t, state_t, _torch_batch(batch), cfg=cfg_t,
        hyper=SSLHyper(**HYPER), opt=opt, lr=LR, pairwise="auto")
    assert out_p is params_t and out_s is state_t       # in place
    for key in met_j:
        _close_metric(met_t[key], met_j[key])
    # The state after one step is g²: the gradients, squared.
    for a, b in zip(_leaves_np(out_s["accum"]),
                    jax.tree.leaves(state_j["accum"])):
        _close(a, b, 2 * GRAD_RTOL)
    # The update on the reference's own gradients is the reference's.
    params_t2 = to_torch(params_j)
    opt.update(to_torch(jax.device_get(grads_j)), opt.init(params_t2),
               params_t2, LR)
    for a, b in zip(_leaves_np(params_t2), jax.tree.leaves(new_j)):
        _close(a, b, VALUE_RTOL)


def test_lm_supervised_step_skips_the_ssl_terms(model):
    cfg_j, cfg_t, params_j = model
    batch = _lm_batch(cfg_j, 1, 4, 10, seed=5)
    opt = adagrad()
    params_t = to_torch(params_j)
    gr.reset_launch_counts()
    _, _, met = tstep.lm_supervised_step(
        params_t, opt.init(params_t), _torch_batch(batch), cfg=cfg_t,
        opt=opt, lr=LR)
    assert set(met) == {"loss/ce", "loss/moe_aux", "loss/total"}
    want = jstep.lm_loss(params_j, cfg_j,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         None)[1]
    for key in met:
        _close_metric(met[key], want[key])


def test_convert_carries_lm_params_and_adagrad_state_bit_for_bit(model):
    cfg_j, _, params_j = model
    opt = jadagrad()
    state = jax.device_get(opt.init(params_j))
    tree = {"params": params_j, "opt_state": state}
    back = to_numpy(to_torch(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


# ---------------------------------------------- sliding windows (ATTN_SWA)
def test_swa_prefill_ring_caches_and_decode_match():
    """Prefill past the window (T 40 > w 16) and 5 decode steps, the ring
    cache wrapping around, against the reference; and a prefill shorter
    than the window (slots padded to w)."""
    cfg_j, cfg_t = _cfgs(block_pattern=(ATTN_SWA,), sliding_window=16)
    params_j = jax.device_get(jtf.init_params(cfg_j, jax.random.PRNGKey(3)))
    params_t = to_torch(params_j)
    rng = np.random.default_rng(3)
    B, T, steps = 2, 40, 5
    toks = rng.integers(0, cfg_j.vocab_size, (B, T + steps)).astype(np.int32)
    for Tp in (T, 9):
        out_j, cache_j = jtf.prefill(params_j, cfg_j, jnp.asarray(toks[:, :Tp]),
                                     cache_len=Tp + steps)
        gr.reset_launch_counts()
        out_t, cache_t = tf.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :Tp]).long(),
                                    cache_len=Tp + steps)
        assert not any(gr.launch_counts().values())     # no K11 with windows
        _close(out_t["logits"].numpy(), out_j["logits"], VALUE_RTOL)
        for cj, ct in zip(jax.device_get(cache_j)["layers"],
                          to_numpy(cache_t)["layers"]):
            assert ct.k.shape[2] == 16                   # window slots
            for f in ("positions", "valid"):
                np.testing.assert_array_equal(getattr(ct, f),
                                              np.asarray(getattr(cj, f)))
            for f in ("k", "v"):
                _close(getattr(ct, f), getattr(cj, f), VALUE_RTOL)
        for s in range(steps):
            pos = np.full((B,), Tp + s, np.int32)
            cur = toks[:, Tp + s:Tp + s + 1]
            lj, cache_j = jtf.decode_step(params_j, cfg_j, cache_j,
                                          jnp.asarray(cur), jnp.asarray(pos))
            lt, cache_t = tf.decode_step(params_t, cfg_t, cache_t,
                                         torch.from_numpy(cur).long(),
                                         torch.from_numpy(pos))
            _close(lt.numpy(), lj, 1e-4)
        np.testing.assert_array_equal(
            cache_t["layers"][0].positions.numpy(),
            np.asarray(cache_j["layers"][0].positions))


def test_swa_init_cache_matches_and_long_context_config_is_served():
    cfg_j, cfg_t = _cfgs(block_pattern=(ATTN_SWA,), sliding_window=16)
    for cache_len in (8, 40):
        want = jax.device_get(jtf.init_cache(cfg_j, 2, cache_len))
        got = tf.init_cache(cfg_t, 2, cache_len)
        for f in ("k", "v", "positions", "valid"):
            a = np.asarray(getattr(want["layers"][0], f))
            b = getattr(got["layers"][0], f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    long = tshapes.config_for_shape(get_config("qwen2-1.5b"),
                                    tshapes.INPUT_SHAPES["long_500k"])
    tf.check_supported(long)
    assert long.block_pattern == (ATTN_SWA,)
    assert long.sliding_window == tshapes.LONG_CONTEXT_WINDOW


# -------------------------------------------------------------- example
def test_train_lm_ssl_example_runs_on_the_cpu(capsys):
    gr.reset_launch_counts()
    hist = train_lm_ssl.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "meta-batches" in out and "done: 2 steps" in out
    assert len(hist) == 2
    for row in hist:
        assert {"loss/ce", "ssl/graph", "loss/total"} <= set(row)
        assert all(np.isfinite(v) for v in row.values())
    assert not any(gr.launch_counts().values())
