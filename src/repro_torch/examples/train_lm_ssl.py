"""End-to-end driver: train a transformer LM with the paper's graph-SSL
objective on a synthetic topic-structured token corpus.

The port's counterpart of ``examples/train_lm_ssl.py``, with the same flags,
scales and batch assembly.  The sequence-level affinity graph (bag-of-tokens
k-NN) feeds the Eq.-3 regularizer on the pooled output distribution while
the usual next-token CE trains the LM.  Components come from the
``repro_torch.api`` registries: the graph builder and the pairwise
Hc(p_i,p_j) entry are both selected by name (``--pairwise auto`` runs the
fused regularizer, K1 forward and K2 backward on the card).  ``--scale``
picks the model size:

  small (default, ≈ 11M params) | mid ≈ 40M | large ≈ 110M

    PYTHONPATH=src python -m repro_torch.examples.train_lm_ssl --steps 60
    PYTHONPATH=src python -m repro_torch.examples.train_lm_ssl --device cpu --steps 2

Runs on the card unless ``--device cpu`` is given; the weights are drawn
from a seeded ``torch.Generator`` on the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import AFFINITY
from repro_torch.core import SSLHyper, plan_meta_batches
from repro_torch.core.metabatch import NeighborSampler
from repro_torch.data import make_token_corpus, sequence_features
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.optim import adagrad
from repro_torch.train.train_step import lm_train_step

SCALES = {
    "small": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=1024, vocab_size=8192),
    "mid": dict(n_layers=8, d_model=448, n_heads=8, n_kv_heads=4,
                d_ff=1792, vocab_size=16384),
    "large": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                  d_ff=2560, vocab_size=32768),
}
N_SEQS = 512
LR = 3e-3


def lm_config(scale: str) -> ModelConfig:
    return ModelConfig(name=f"lm-{scale}", family="dense",
                       block_pattern=(ATTN,), activation="swiglu",
                       norm="rmsnorm", dtype="float32", rope_theta=1e4,
                       **SCALES[scale])


def build_data(vocab: int, seq_len: int, batch: int, *,
               graph_builder: str = "knn_rbf", n_seqs: int = N_SEQS) -> dict:
    """The example's host pipeline: token corpus (``seq_len + 1`` tokens a
    sequence), bag-of-tokens features, k-NN graph (k = 10), meta-batch plan
    of ``batch`` sequences, neighbour sampler, and the 5 % of sequences
    whose topic is a label."""
    toks, topics = make_token_corpus(n_seqs, seq_len + 1, vocab, n_topics=8,
                                     seed=0)
    feats = sequence_features(toks, vocab, dim=64, seed=0)
    graph = AFFINITY.get(graph_builder)(feats, k=10)
    plan = plan_meta_batches(graph, batch_size=batch, n_classes=4, seed=0)
    sampler = NeighborSampler(plan.batch_edges, seed=0)
    rng = np.random.default_rng(0)
    label_mask = rng.random(n_seqs) < 0.05
    return {"toks": toks, "topics": topics, "graph": graph, "plan": plan,
            "sampler": sampler, "label_mask": label_mask}


def batches(data: dict, batch: int, steps: int, device: torch.device):
    """``steps`` batches in the reference's order: each pass over the plan
    is a permutation seeded with the step it starts at; a meta-batch is
    concatenated with a sampled neighbour, cut or edge-padded to
    ``2·batch`` sequences, and carries its dense affinity block (one SSL
    group, G = 1)."""
    toks, topics, plan = data["toks"], data["topics"], data["plan"]
    size = batch * 2
    i = 0
    while i < steps:
        order = np.random.default_rng(i).permutation(plan.n_meta)
        for mi in order:
            nb = data["sampler"].sample(int(mi))
            idx = plan.meta_batches[mi]
            if nb is not None:
                idx = np.concatenate([idx, plan.meta_batches[nb]])
            idx = idx[:size]
            if len(idx) < size:   # pad to static shape
                idx = np.pad(idx, (0, size - len(idx)), mode="edge")
            W = data["graph"].dense_block(idx)
            seq_len = toks.shape[1] - 1
            host = {
                "tokens": torch.from_numpy(toks[idx][:, :-1]).long(),
                "targets": torch.from_numpy(toks[idx][:, 1:]).long(),
                "loss_mask": torch.ones((len(idx), seq_len),
                                        dtype=torch.float32),
                "W": torch.from_numpy(np.asarray(W, np.float32))[None],
                "seq_labels": torch.from_numpy(
                    topics[idx].astype(np.int32))[None],
                "seq_label_mask": torch.from_numpy(
                    data["label_mask"][idx].astype(np.float32))[None],
            }
            yield {k: v.to(device) for k, v in host.items()}
            i += 1
            if i >= steps:
                break


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=SCALES, default="small")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--graph-builder", default="knn_rbf",
                    help="AFFINITY registry entry")
    ap.add_argument("--pairwise", default="auto",
                    choices=["auto", "ref", "pallas", "fused"],
                    help="PAIRWISE registry entry")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = lm_config(args.scale)
    print(f"model: {cfg.name}  params≈{cfg.param_count()/1e6:.1f}M")
    data = build_data(cfg.vocab_size, args.seq_len, args.batch,
                      graph_builder=args.graph_builder)
    print(f"{N_SEQS} sequences, affinity graph {data['graph'].n_edges} "
          f"edges, {data['plan'].n_meta} meta-batches, "
          f"{data['label_mask'].sum()} topic labels")

    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adagrad()
    opt_state = opt.init(params)
    hyper = SSLHyper(gamma=args.gamma, kappa=1e-4, weight_decay=0.0)

    history = []
    t0 = time.time()
    for i, batch in enumerate(batches(data, args.batch, args.steps, device)):
        params, opt_state, metrics = lm_train_step(
            params, opt_state, batch, cfg=cfg, hyper=hyper, opt=opt, lr=LR,
            pairwise=args.pairwise)
        history.append(metrics)
        if i % 10 == 0:
            print(f"step {i:4d}: ce={float(metrics['loss/ce']):.4f} "
                  f"ssl_graph={float(metrics.get('ssl/graph', 0)):.4f} "
                  f"({(time.time() - t0):.1f}s)")
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s")
    return [{k: float(v) for k, v in m.items()} for m in history]


if __name__ == "__main__":
    main()
