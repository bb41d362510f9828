"""The serving path's dropless MoE layer (``layers.moe.apply_moe_dropless``
with K12's and K13's plain versions) and the serving entry points that
use it, on the CPU in float32.

The layer against a plain loop over the experts, at uniform routing and
at a router that sends every token to expert 0 first (where the capacity
path drops); the plain versions of K12 and K13; a decode step at B = 4
against the prefill of one more token; ``serve_lm.prefill`` and four
dropless decode steps of ``mixtral-8x7b``'s ``reduced()`` against the
benchmark's plain reference (``perfbench/reference/moe_transformer.py``);
``transformer.prefill``'s default (the capacity path, which the JAX parity
tests hold); the spans and routing records of a served prefill, and
the capacity path's records against its keep mask; windowed
layers on K11 while the window covers the prompt.  Tolerances: float32
atol 1e-5 at the layer, 1e-4 of the largest logit over a stack (K11's
and the reference's attention sum in other orders).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import moe_inputs  # noqa: E402
from perfbench.reference import moe_transformer as ref  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe as kmoe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import attention as attn_lib  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.serve import serve_lm  # noqa: E402

D, F, TOP = 32, 48, 2


def _layer(E: int, seed: int = 0, expert0: bool = False):
    """A float32 layer of E experts and its input x (B, T, d); with
    ``expert0`` every input's features are positive and the router's
    first column is all ones, so expert 0 leads every token's choice."""
    p = moe.init_moe(torch.Generator().manual_seed(seed), D, F, E, "swiglu")
    x = torch.randn((3, 29, D), generator=torch.Generator().manual_seed(
        seed + 1))
    if expert0:
        x = x.abs() + 1.0
        p["router"][:, 0] = 1.0
    return p, x


def _loop(p, x, top_k):
    """The layer by a loop over experts, each over exactly its tokens."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p["router"], -1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :top_k], e[:, :top_k]
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for ex in range(p["router"].shape[1]):
        tok, slot = torch.nonzero(e == ex, as_tuple=True)
        h = xf[tok]
        out = (torch.nn.functional.silu(h @ p["wg"][ex])
               * (h @ p["wu"][ex])) @ p["wd"][ex]
        y.index_add_(0, tok, out * w[tok, slot, None])
    return y.reshape(x.shape), e


@pytest.mark.parametrize("E", [4, 8])
@pytest.mark.parametrize("expert0", [False, True])
def test_dropless_layer_matches_a_loop_over_experts(E, expert0):
    p, x = _layer(E, expert0=expert0)
    stats = []
    y = moe.apply_moe_dropless(p, x, top_k=TOP, activation="swiglu",
                               stats=stats)
    want, e = _loop(p, x, TOP)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5, rtol=0)
    (rec,) = stats
    assert torch.equal(rec["experts"], e)
    assert torch.equal(rec["rows"], torch.bincount(e.reshape(-1),
                                                   minlength=E).int())
    assert moe.dropped(rec) == 0 and int(rec["rows"].sum()) == x.shape[0] \
        * x.shape[1] * TOP
    if expert0:
        assert bool((e[:, 0] == 0).all())
        cap = []
        y_cap, _ = moe.apply_moe(p, x, top_k=TOP, capacity_factor=1.25,
                                 activation="swiglu", stats=cap)
        assert moe.dropped(cap[0]) > 0
        assert float((y_cap - want).abs().max()) > 1e-2


def test_dispatch_sorts_stably_and_combine_adds_in_order():
    N, k, E, d = 37, 3, 5, 8
    g = torch.Generator().manual_seed(4)
    x = torch.randn((N, d), generator=g)
    ids = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(N)])
    xs, pos, counts, ends = kmoe.moe_dispatch(x, ids, E)
    assert xs.shape == (N * k, d) and pos.dtype == torch.int32
    assert torch.equal(counts, torch.bincount(ids.reshape(-1),
                                              minlength=E).int())
    assert torch.equal(ends, torch.cumsum(counts, 0).int())
    for e in range(E):
        a = torch.nonzero(ids.reshape(-1) == e)[:, 0]
        lo = int(ends[e] - counts[e])
        assert torch.equal(pos.reshape(-1)[a].long(),
                           torch.arange(lo, lo + a.numel()))
    assert torch.equal(xs[pos.long()], x[:, None].expand(N, k, d))
    w = torch.rand((N, k), generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.randn((N * k, d), generator=g).to(dtype)
        want = w[:, 0, None] * out[pos[:, 0].long()].float()
        for j in range(1, k):
            want = want + w[:, j, None] * out[pos[:, j].long()].float()
        assert torch.equal(kmoe.moe_combine(out, pos, w), want.to(dtype))
    assert kmoe.launch_counts() == {"moe_dispatch": 0, "moe_combine": 0}


def test_kernels_refuse_what_they_do_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="experts"):
        kmoe.moe_dispatch(x, torch.zeros((4, 2), dtype=torch.long), 2000)
    with pytest.raises(ValueError, match="one device"):
        kmoe.moe_dispatch(x, torch.zeros((4, 2), dtype=torch.long,
                                         device="meta"), 4)
    with pytest.raises(ValueError, match="dispatch"):
        tf.prefill({}, get_config("mixtral-8x7b").reduced(),
                   torch.zeros((1, 4), dtype=torch.long),
                   moe_dispatch="nearest")


def _mixtral(seed=0):
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, serve_lm.load_model(cfg, seed=seed,
                                    device=torch.device("cpu"))


def _tokens(cfg, B, T, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)))


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_decode_step_at_batch_4_matches_the_prefill_of_one_more_token():
    cfg, params = _mixtral()
    toks = _tokens(cfg, 4, 21)
    _, cache = tf.prefill(params, cfg, toks[:, :-1], cache_len=21,
                          moe_dispatch="dropless")
    step, _ = tf.decode_step(params, cfg, cache, toks[:, -1:],
                             torch.full((4,), 20, dtype=torch.int32),
                             moe_dispatch="dropless")
    full, _ = tf.prefill(params, cfg, toks, cache_len=21,
                         moe_dispatch="dropless")
    _close(step[:, 0], full["logits"][:, -1])


def test_serve_path_matches_the_plain_reference():
    """``serve_lm.prefill`` of 16 tokens and 4 dropless decode steps of
    the reduced config's stack, from the benchmark's weights, against the
    reference's forward pass over all 20 tokens (its own routing)."""
    cfg = get_config("mixtral-8x7b").reduced()
    c = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
         "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
         "head_dim": cfg.hd, "d_ff": cfg.moe_d_ff,
         "n_experts": cfg.n_experts, "top_k": cfg.top_k,
         "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
         "norm_eps": 1e-6, "dtype": "float32"}
    w = moe_inputs.make_weights(c, 11, torch.device("cpu"))
    params = moe_inputs.program_tree(w)
    T, steps = 16, 4
    toks = _tokens(cfg, 2, T + steps)
    out, cache = serve_lm.prefill(params, cfg, toks[:, :T], steps)
    got = [out["logits"]]
    for s in range(steps):
        lg, cache = tf.decode_step(
            params, cfg, cache, toks[:, T + s:T + s + 1],
            torch.full((2,), T + s, dtype=torch.int32),
            moe_dispatch="dropless")
        got.append(lg)
    _, _, logits, info = ref.prefill(w, c, toks)
    _close(torch.cat(got, dim=1), logits(0, T + steps))
    for rec, own in zip(out["moe"], info["routes"]):
        assert torch.equal(rec["experts"], own[:, :T].reshape(-1, c["top_k"]))
        assert moe.dropped(rec) == 0


def test_prefill_default_is_the_capacity_path():
    cfg, params = _mixtral(seed=3)
    toks = _tokens(cfg, 2, 24)
    default, _ = tf.prefill(params, cfg, toks, cache_len=26)
    cap, _ = tf.prefill(params, cfg, toks, cache_len=26,
                        moe_dispatch="capacity")
    free, _ = tf.prefill(params, cfg, toks, cache_len=26,
                         moe_dispatch="dropless")
    assert torch.equal(default["logits"], cap["logits"])
    drops = [moe.dropped(r) for r in default["moe"]]
    assert sum(drops) > 0 and not any(moe.dropped(r) for r in free["moe"])
    assert not torch.equal(default["logits"], free["logits"])


def test_moe_spans_and_records_of_a_served_prefill():
    """Each MoE layer of a recorded ``serve_lm.prefill``: an ``ffn.moe``
    span holding the router, K12, the expert products (``ffn.mlp``) and
    K13, and a routing record in the output: every assignment computed."""
    cfg, params = _mixtral()
    B, T = 2, 16
    spans.clear()
    with spans.recording():
        out, _ = serve_lm.prefill(params, cfg, _tokens(cfg, B, T), 4)
    recs = spans.records()
    spans.clear()
    moe_spans = [r for r in recs if r["name"] == "ffn.moe"]
    assert len(moe_spans) == len(out["moe"]) == cfg.n_layers
    for r, rec in zip(moe_spans, out["moe"]):
        children = [c["name"] for c in recs if c["parent"] == r["id"]]
        assert children == ["moe.route", "kernel.moe_dispatch", "ffn.mlp",
                            "kernel.moe_combine"]
        assert rec["experts"].shape == (B * T, cfg.top_k)
        assert int(rec["rows"].sum()) == B * T * cfg.top_k
        assert moe.dropped(rec) == 0


def test_capacity_records_count_what_the_keep_mask_kept(monkeypatch):
    """The capacity path's records agree with its keep mask: the rows of
    each expert are its kept assignments, and ``dropped`` the rest."""
    cfg, params = _mixtral(seed=3)
    keeps = []
    slots = moe.slots

    def recording(top_e, n_experts, cap):
        got = slots(top_e, n_experts, cap)
        keeps.append((top_e, got[1]))
        return got

    monkeypatch.setattr(moe, "slots", recording)
    out, _ = tf.prefill(params, cfg, _tokens(cfg, 2, 24), cache_len=26)
    assert len(keeps) == len(out["moe"]) == cfg.n_layers
    for rec, (e, keep) in zip(out["moe"], keeps):
        assert moe.dropped(rec) == int((~keep).sum())
        want = torch.bincount(e[keep], minlength=cfg.n_experts)
        assert torch.equal(rec["rows"], want.to(torch.int32))
    assert sum(map(moe.dropped, out["moe"])) > 0


@pytest.mark.parametrize("T,k11", [(40, True), (80, False)])
def test_windowed_layers_run_k11_while_the_window_covers_the_prompt(
        monkeypatch, T, k11):
    cfg, params = _mixtral()
    calls = []
    flash = attn_lib.ops.flash_attention_gqa

    def counted(*a, **kw):
        calls.append(1)
        return flash(*a, **kw)

    monkeypatch.setattr(attn_lib.ops, "flash_attention_gqa", counted)
    toks = _tokens(cfg, 2, T)
    out, cache = tf.prefill(params, cfg, toks, cache_len=T + 1)
    assert len(calls) == (cfg.n_layers if k11 else 0)
    assert cache["layers"][0].k.shape[2] == cfg.sliding_window
    if k11:
        whole = dataclasses.replace(cfg, sliding_window=None,
                                    block_pattern=("attn",))
        want, _ = tf.prefill(params, whole, toks, cache_len=T + 1)
        assert torch.equal(out["logits"], want["logits"])
