"""The reference's side of a training cell: it follows the program's first
steps from the same seed.

The program's batches are read only to judge them: each row is matched to
the corpus row it holds, and the reference builds its own batch from the
corpus (tokens, next tokens, topic labels, label mask) and its own graph
(``graph.affinity``).  Weights come from the harness's generator, the
same draw the program was given, in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import compare, graph
from . import transformer as ref


def match_rows(batch_tokens: np.ndarray, corpus: np.ndarray) -> tuple:
    """(corpus row of each batch row, rows that are no corpus row): the
    row that agrees on the most tokens, and whether it agrees on all."""
    body = corpus[:, :-1]
    ids, bad = [], 0
    for row in batch_tokens:
        agree = (body == row[None, :]).sum(axis=1)
        i = int(np.argmax(agree))
        ids.append(i)
        bad += int(agree[i] != body.shape[1])
    return np.asarray(ids), bad


def follow(c: dict, traffic: dict, *, seed: int, corpus: np.ndarray,
           topics: np.ndarray, label_mask: np.ndarray, batches: list,
           device, precision: str = "f32") -> dict:
    """The reference's steps over the corpus rows of ``batches`` (the
    program's, as host tensors): each step's losses, every leaf's first
    gradient norm and its change after the steps, the graph's blocks and
    how many rows or labels of the program's batches were not the
    corpus's."""
    from perfbench.harness import inputs
    ref.set_precision()
    W = graph.affinity(corpus, c["vocab_size"], dim=c["ssl"]["feature_dim"],
                       k=c["ssl"]["knn_k"])
    w0 = inputs.make_weights(c, seed, device)
    w = ref.to_f32(w0)
    for t in w.values():
        t.requires_grad_(True)
    accum = {k: torch.zeros_like(v) for k, v in w.items()}
    out = {"losses": [], "w_blocks": [], "mismatch": 0}
    for i, b in enumerate(batches):
        ids, bad = match_rows(b["tokens"].numpy(), corpus)
        bad += int((b["targets"].numpy() != corpus[ids, 1:]).any(axis=1).sum())
        bad += int((b["seq_labels"].numpy()[0] != topics[ids]).sum())
        bad += int((b["seq_label_mask"].numpy()[0]
                    != label_mask[ids].astype(np.float32)).sum())
        out["mismatch"] += bad
        block = W[np.ix_(ids, ids)]
        out["w_blocks"].append(block)
        rb = {"tokens": torch.from_numpy(corpus[ids, :-1]).long().to(device),
              "targets": torch.from_numpy(corpus[ids, 1:]).long().to(device),
              "loss_mask": torch.ones(corpus[ids, 1:].shape, device=device),
              "W": torch.from_numpy(block).float().to(device),
              "seq_labels": torch.from_numpy(topics[ids]).long().to(device),
              "seq_label_mask": torch.from_numpy(
                  label_mask[ids].astype(np.float32)).to(device)}
        out["losses"].append(ref.loss_and_grads(
            w, c, rb, gamma=c["ssl"]["gamma"], kappa=c["ssl"]["kappa"],
            precision=precision))
        if i == 0:
            out["grad1"] = compare.slice_norms(
                {k: v.grad for k, v in w.items()}, c["n_layers"])
        ref.adagrad(w, accum, traffic["lr"])
        del rb
    with torch.no_grad():
        out["delta"] = compare.slice_norms(
            w, c["n_layers"], fn=lambda name, t: t - w0[name].float())
    return out
