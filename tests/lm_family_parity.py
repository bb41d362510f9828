"""Stack-level parity of one architecture's ``reduced()`` config, shared by
the family test files (``test_torch_moe.py``, ``test_torch_xattn.py``,
``test_torch_mamba.py``, ``test_torch_xlstm.py``).

The reference's params (``repro.models.transformer.init_params``, with
every XATTN gate set to a seeded non-zero value: the reference starts it
at 0, and tanh(0)·out = 0 would hide the cross-attention) are carried
into the port by ``convert.to_torch``; the same numpy tokens (and, for a
VLM, modality embeddings) go through both packages' ``forward``,
``lm_loss`` with the sequence-level SSL term and its gradients,
``prefill``, 4 ``decode_step``s and greedy ``generate``.  Both packages'
caches are flattened by ``convert.leaf_paths``, whose paths name each
decode state's class, and compared path by path.

Tolerances, as ``tests/test_torch_lm.py`` and
``tests/test_torch_lm_train.py`` hold the dense stack: float32 values atol
1e-4; ``lm_loss`` metrics rtol 1e-4 (atol 1e-4·max(1, |want|)); each
gradient leaf within 1e-3 of its own largest |value|.  A leaf whose
gradient is zero analytically is named to ``check_grads`` and holds only
round-off, in both packages: at most 2^-20 (16 units of float32
round-off) of the largest |value| over all leaves.  sLSTM's input-gate
bias is the one such leaf: a constant added to every input-gate
pre-activation scales c and n alike, so h does not move (its largest
|gradient| in either package is 2.2e-9 of the largest leaf's in the
reduced xlstm-125m stack, 2.1e-7 in a T = 256 block; every other leaf's
is at least 6e-5 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.core.ssl_loss import SSLHyper as JHyper
from repro.models import transformer as jtf
from repro.models.layers.attention import KVCache as JKVCache
from repro.models.layers.mamba import MambaState as JMambaState
from repro.models.layers.xlstm import MLSTMState as JMLSTMState
from repro.models.layers.xlstm import SLSTMState as JSLSTMState
from repro.serve import decode as jdecode
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import leaf_paths, to_numpy, to_torch
from repro_torch.core.ssl_loss import SSLHyper, tree_leaves
from repro_torch.models import transformer as tf
from repro_torch.serve import decode
from repro_torch.train import train_step as tstep

ATOL, METRIC_RTOL, GRAD_TOL = 1e-4, 1e-4, 1e-3
ZERO_ROUNDOFF = 2.0 ** -20
HYPER = dict(gamma=0.05, kappa=1e-4, weight_decay=0.0)
#: The reference's decode-state classes, by the port's class names.
JAX_STATES = {c.__name__: c for c in (JKVCache, JMambaState, JSLSTMState,
                                      JMLSTMState)}
B, T, STEPS = 2, 16, 4


def reference_params(arch: str, seed: int = 1):
    """(cfg_j, cfg_t, params_j as numpy) of the reduced config; XATTN gates
    set to seeded values in [0.3, 0.9)."""
    cfg_j, cfg_t = jax_config(arch).reduced(), get_config(arch).reduced()
    params_j = jax.device_get(jtf.init_params(cfg_j, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in params_j["superblocks"]:
        attn = layer.get("attn", {})
        if "gate" in attn:
            attn["gate"] = rng.uniform(0.3, 0.9, attn["gate"].shape).astype(
                np.float32)
    return cfg_j, cfg_t, params_j


def modality(cfg, batch: int, seed: int = 0):
    if not cfg.modality_tokens:
        return None
    rng = np.random.default_rng(seed + 100)
    return rng.normal(size=(batch, cfg.modality_tokens,
                            cfg.modality_dim)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def flat(cache):
    """(path, numpy leaf) pairs of either package's cache tree."""
    return [(p, to_numpy(x)) for p, x in leaf_paths(cache)]


def same_tree(got, want):
    """The leaf pairs of two ``flat`` trees, once their paths agree."""
    assert [p for p, _ in got] == [p for p, _ in want]
    return [(a, b) for (_, a), (_, b) in zip(got, want)]


def stack_run(arch: str) -> dict:
    """Both packages' outputs on one reduced config (see the module
    docstring)."""
    cfg_j, cfg_t, params_j = reference_params(arch)
    params_t = to_torch(params_j)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg_j.vocab_size, (B, T + STEPS)).astype(np.int32)
    mem = modality(cfg_j, B)
    run = {"cfg_j": cfg_j, "cfg_t": cfg_t, "params_j": params_j,
           "params_t": params_t, "toks": toks, "mem": mem}
    run["fwd_j"] = jax.device_get(jtf.forward(
        params_j, cfg_j, jnp.asarray(toks[:, :T]), modality_embeds=_j(mem)))
    run["fwd_t"] = tf.forward(params_t, cfg_t,
                              torch.from_numpy(toks[:, :T]).long(),
                              modality_embeds=_t(mem))
    out_j, cache_j = jtf.prefill(params_j, cfg_j, jnp.asarray(toks[:, :T]),
                                 modality_embeds=_j(mem),
                                 cache_len=T + STEPS)
    out_t, cache_t = tf.prefill(params_t, cfg_t,
                                torch.from_numpy(toks[:, :T]).long(),
                                modality_embeds=_t(mem), cache_len=T + STEPS)
    run["prefill"] = (np.asarray(out_j["logits"]), out_t["logits"].numpy())
    run["cache"] = (flat(cache_j), flat(cache_t))
    steps = []
    jdecode_step = jax.jit(jtf.decode_step, static_argnums=1)
    for s in range(STEPS):
        tok = toks[:, T + s:T + s + 1]
        pos = np.full((B,), T + s, np.int32)
        lj, cache_j = jdecode_step(params_j, cfg_j, cache_j,
                                   jnp.asarray(tok), jnp.asarray(pos))
        lt, cache_t = tf.decode_step(params_t, cfg_t, cache_t,
                                     torch.from_numpy(tok).long(),
                                     torch.from_numpy(pos))
        steps.append((np.asarray(lj), lt.numpy().copy()))
    run["decode"] = steps
    run["cache_after"] = (flat(cache_j), flat(cache_t))
    if mem is None:     # generate feeds no modality embeddings
        prompt = toks[:, :6]
        run["greedy"] = (
            np.asarray(jdecode.generate(params_j, cfg_j, jnp.asarray(prompt),
                                        steps=5, cache_len=12)),
            decode.generate(params_t, cfg_t, torch.from_numpy(prompt).long(),
                            steps=5, cache_len=12).numpy())
    return run


def lm_batch(cfg, G: int, b: int, Tb: int, seed: int = 0) -> dict:
    """Token batch with the SSL group fields (and modality embeddings for a
    VLM), numpy."""
    rng = np.random.default_rng(seed)
    n = G * b
    toks = rng.integers(0, cfg.vocab_size, (n, Tb + 1)).astype(np.int32)
    W = rng.random((G, b, b)) * (rng.random((G, b, b)) < 0.5)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((n, Tb)) < 0.9).astype(np.float32),
             "W": (W + W.swapaxes(1, 2)).astype(np.float32),
             "seq_labels": rng.integers(0, cfg.vocab_size,
                                        (G, b)).astype(np.int32),
             "seq_label_mask": (rng.random((G, b)) < 0.5).astype(np.float32)}
    mem = modality(cfg, n, seed)
    if mem is not None:
        batch["modality_embeds"] = mem
    return batch


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "targets"):
        out[k] = out[k].long()
    return out


def lm_loss_run(run: dict, G: int = 1, b: int = 4, Tb: int = 12) -> dict:
    """``lm_loss`` metrics and gradients of both packages on one batch, the
    SSL term on the plain versions (the reference's ``"ref"``), with each
    gradient leaf's path and the paths of the sLSTM input-gate biases."""
    batch = lm_batch(run["cfg_j"], G, b, Tb, seed=3)

    @jax.jit
    def loss_and_grads(params, batch):
        return jax.value_and_grad(jstep.lm_loss, has_aux=True)(
            params, run["cfg_j"], batch, JHyper(**HYPER), pairwise="ref")

    (loss_j, met_j), grads_j = loss_and_grads(
        run["params_j"], {k: jnp.asarray(v) for k, v in batch.items()})
    grads_t, met_t = tstep.lm_grads(
        run["params_t"], torch_batch(batch), cfg=run["cfg_t"],
        hyper=SSLHyper(**HYPER), pairwise="auto")
    paths, leaves_j = zip(*jax.tree_util.tree_flatten_with_path(
        jax.device_get(grads_j))[0])
    zero = [f"['superblocks'][{i}]['block']['bi']"
            for i, kind in enumerate(run["cfg_j"].block_pattern)
            if kind == "slstm"]
    return {"met_j": {**jax.device_get(met_j), "loss": float(loss_j)},
            "met_t": met_t, "grads_j": list(leaves_j),
            "grads_t": tree_leaves(grads_t),
            "names": [jax.tree_util.keystr(p) for p in paths], "zero": zero}


# ------------------------------------------------------------ assertions
def close(got, want, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def check_forward(run):
    fj, ft = run["fwd_j"], run["fwd_t"]
    for key in ("hidden", "pooled_logits", "logits", "moe_aux"):
        close(ft[key].detach().numpy(), fj[key])
    assert ft["moe_aux"].dtype == torch.float32


def check_prefill_and_cache(run):
    close(run["prefill"][1], run["prefill"][0])
    for a, b in same_tree(run["cache"][1], run["cache"][0]):
        assert a.shape == b.shape and a.dtype == b.dtype
        close(a, b)


def check_decode(run):
    for lj, lt in run["decode"]:
        close(lt, lj)
    for a, b in same_tree(run["cache_after"][1], run["cache_after"][0]):
        close(a, b)


def check_lm_loss(res):
    met_j, met_t = res["met_j"], res["met_t"]
    assert set(met_t) == set(met_j) - {"loss"}
    for key in met_t:
        want = float(met_j[key])
        np.testing.assert_allclose(float(met_t[key]), want,
                                   rtol=METRIC_RTOL,
                                   atol=METRIC_RTOL * max(1.0, abs(want)))
    np.testing.assert_allclose(float(met_t["loss/total"]), met_j["loss"],
                               rtol=METRIC_RTOL)
    check_grads(res["grads_t"], res["grads_j"], res["names"], res["zero"])


def check_grads(grads_t, grads_j, names, zero=()):
    """Each leaf within GRAD_TOL of its own largest |value|; a leaf named in
    ``zero`` (its gradient is zero analytically) within ZERO_ROUNDOFF of the
    largest |value| over all leaves, in both packages.  Prints each leaf's
    largest |value| and error (shown by ``pytest -s``)."""
    grads_j = [np.asarray(b, np.float64) for b in grads_j]
    assert len(grads_t) == len(grads_j) == len(names)
    assert set(zero) <= set(names), sorted(set(zero) - set(names))
    top = max(float(np.abs(b).max()) for b in grads_j)
    for name, a, b in zip(names, grads_t, grads_j):
        assert tuple(a.shape) == b.shape, name
        a = a.detach().numpy().astype(np.float64)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        worst = max(scale, float(np.abs(a).max())) / top
        print(f"grad {name}: largest |value| {scale:.3e} "
              f"({scale / top:.2e} of the largest leaf's, {worst:.2e} in "
              f"either package), |Δ| {err:.3e}")
        if name in zero:
            assert worst <= ZERO_ROUNDOFF, (name, worst)
        else:
            assert err <= GRAD_TOL * scale, (name, err / scale)


def mean_rel(got, want) -> float:
    """mean |Δ| / std(want), ``tests/test_torch_lm.py``'s bf16 measure."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).mean() / (np.abs(want).std() + 1e-9))
