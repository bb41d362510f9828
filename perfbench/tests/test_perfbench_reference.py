"""The plain reference against the port at small sizes on the CPU, both in
float32: they compute the same model, so they agree to float32 round-off.
(At the cells' sizes on the card the port runs in bfloat16 and the limits
of ``perfbench/limits`` hold it; this holds the reference itself.)"""

import numpy as np
import pytest
import torch

from perfbench.harness import common, inputs
from perfbench.reference import compare, graph
from perfbench.reference import transformer as ref
from perfbench.tests.cells import TINY, prefill_cell, train_cell

F32 = dict(TINY, dtype="float32")


def _cfg(c):
    return common.program_config(c, strict=False)


@pytest.mark.parametrize("workload", ["qwen2-1.5b.prefill_2k",
                                      "phi4-mini-3.8b.prefill_2k"])
def test_prefill_logits_and_cache(workload):
    from repro_torch.models import transformer as tf
    c = dict(prefill_cell(workload).config, **F32)
    cpu = torch.device("cpu")
    w = inputs.make_weights(c, 5, cpu)
    tokens = inputs.prompts(1, 3, 40, c["vocab_size"], seed=5, device=cpu)[0]
    out, cache = tf.prefill(inputs.program_tree(w), _cfg(c), tokens,
                            cache_len=41)
    _, kv, logits = ref.prefill(ref.to_f32(w), c, tokens)
    want = logits(0, 40)
    assert torch.allclose(out["logits"], want, rtol=1e-4, atol=1e-5)
    layers = cache["layers"][0]
    for l, (k, v) in enumerate(kv):
        assert torch.allclose(layers.k[l][:, :40], k, rtol=1e-4, atol=1e-5)
        assert torch.allclose(layers.v[l][:, :40], v, rtol=1e-4, atol=1e-5)


def test_training_losses_and_gradients():
    from repro_torch.core import SSLHyper
    from repro_torch.train.train_step import lm_grads
    cell = train_cell({})
    c = dict(cell.config, **F32)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    B, T, V = 8, 24, c["vocab_size"]
    toks = torch.from_numpy(rng.integers(0, V, (B, T + 1)))
    W = rng.random((B, B)) * (rng.random((B, B)) < 0.3)
    W = np.float32(np.maximum(W, W.T) * (1 - np.eye(B)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": torch.ones(B, T),
             "W": torch.from_numpy(W)[None],
             "seq_labels": torch.from_numpy(rng.integers(0, 4, B))[None],
             "seq_label_mask": torch.tensor(
                 [[1.0, 0, 0, 1, 0, 0, 0, 1]])}
    w = inputs.make_weights(c, 7, cpu)
    s = c["ssl"]
    grads, metrics = lm_grads(inputs.program_tree(w), batch, cfg=_cfg(c),
                              hyper=SSLHyper(s["gamma"], s["kappa"], 0.0),
                              pairwise="auto")
    rw = ref.to_f32(w)
    for t in rw.values():
        t.requires_grad_(True)
    rb = dict(batch, W=batch["W"][0], seq_labels=batch["seq_labels"][0],
              seq_label_mask=batch["seq_label_mask"][0])
    losses = ref.loss_and_grads(rw, c, rb, gamma=s["gamma"],
                                kappa=s["kappa"], seq_block=3, chunk=16)
    for k in compare.LOSSES:
        assert float(metrics[k]) == pytest.approx(losses[k], rel=1e-5,
                                                  abs=1e-6), k
    got = common.flat_leaves(grads)
    for name, t in rw.items():
        assert torch.allclose(got[name], t.grad, rtol=1e-4, atol=1e-6), name


def test_graph_block_matches_the_program_graph():
    from repro_torch.core.affinity import build_affinity_graph
    from repro_torch.data import sequence_features
    toks, _ = inputs.token_corpus(48, 65, 512, n_topics=4, zipf=1.1,
                                  topic_share=0.05, topic_boost=40.0, seed=9)
    W = graph.affinity(toks, 512, dim=16, k=5)
    prog = build_affinity_graph(sequence_features(toks, 512, dim=16, seed=0),
                                k=5).W.toarray()
    assert np.abs(prog - W).max() <= 1e-4 * np.abs(W).max()


def test_rope_fraction_leaves_the_tail():
    x = torch.randn(1, 5, 2, 8)
    y = ref.rope(x, 1e4, fraction=0.5)
    assert torch.equal(y[..., 4:], x[..., 4:])
    assert torch.equal(ref.rope(x[:, :1], 1e4), x[:, :1])


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref._fq(x)
    err = (y - x).detach().abs()
    # e4m3 keeps 3 bits of mantissa: half a step is 1/16 of the value.
    assert 0 < float(err.max()) and bool((err <= x.detach().abs() / 16
                                           + 1e-6).all())
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
