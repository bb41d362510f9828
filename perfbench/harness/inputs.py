"""Inputs made from the seed: weights, the token corpus and the prompts.

Both sides of a comparison get these from here: the program under test
and the plain reference.  The weights are drawn on the device with one
``torch.Generator`` in two large calls (one for the matrices, in the
configuration's dtype, one for the float32 norm scales) and handed out as
views of those two buffers.  The corpus generator is this harness's own
copy of the LM example's (a Zipf backbone, each topic boosting a random
share of the vocabulary), drawn by inverse CDF in one vectorised call.
"""
from __future__ import annotations

import numpy as np
import torch

#: Norm scales are 1 + NORM_JITTER · N(0, 1); biases have std BIAS_STD.
NORM_JITTER = 0.05
BIAS_STD = 0.02
EMBED_STD = 0.02


def leaf_specs(c: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every leaf of a dense GQA decoder with
    the sizes of configuration ``c``; layer leaves are stacked over the
    layers on a leading axis, ``kind`` is ``"w"`` for a matrix or bias (the
    configuration's dtype) and ``"norm"`` for a float32 norm scale."""
    L, d, H, KV = c["n_layers"], c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd, ff, V = c["head_dim"], c["d_ff"], c["vocab_size"]
    specs = [("embed.table", (V, d), "w", EMBED_STD),
             ("final_norm.scale", (d,), "norm", 0.0)]
    if not c["tie_embeddings"]:
        specs.append(("lm_head", (d, V), "w", d ** -0.5))
    specs += [("norm1.scale", (L, d), "norm", 0.0),
              ("attn.wq", (L, d, H, hd), "w", d ** -0.5),
              ("attn.wk", (L, d, KV, hd), "w", d ** -0.5),
              ("attn.wv", (L, d, KV, hd), "w", d ** -0.5),
              ("attn.wo", (L, H, hd, d), "w", (H * hd) ** -0.5)]
    if c["qkv_bias"]:
        specs += [("attn.bq", (L, H, hd), "w", BIAS_STD),
                  ("attn.bk", (L, KV, hd), "w", BIAS_STD),
                  ("attn.bv", (L, KV, hd), "w", BIAS_STD)]
    specs += [("norm2.scale", (L, d), "norm", 0.0),
              ("mlp.wg", (L, d, ff), "w", d ** -0.5),
              ("mlp.wu", (L, d, ff), "w", d ** -0.5),
              ("mlp.wd", (L, ff, d), "w", ff ** -0.5)]
    return specs


def make_weights(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> leaf, drawn from ``seed`` on ``device``: matrices in the
    configuration's dtype, norm scales in float32."""
    specs = leaf_specs(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for kind, dtype in (("w", getattr(torch, c["dtype"])),
                        ("norm", torch.float32)):
        mine = [s for s in specs if s[2] == kind]
        total = sum(int(np.prod(shape)) for _, shape, _, _ in mine)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        at = 0
        for name, shape, _, std in mine:
            n = int(np.prod(shape))
            leaf = flat[at:at + n].view(shape)
            at += n
            if kind == "w":
                leaf.mul_(std)
            else:
                leaf.mul_(NORM_JITTER).add_(1.0)
            out[name] = leaf
    return out


def program_tree(w: dict[str, torch.Tensor]) -> dict:
    """The leaves in the nest of ``repro_torch.models.transformer``'s params
    (one pattern position, ``ATTN``)."""
    layer: dict = {}
    for name, leaf in w.items():
        group, _, key = name.partition(".")
        if group in ("norm1", "attn", "norm2", "mlp"):
            layer.setdefault(group, {})[key] = leaf
    tree = {"embed": {"table": w["embed.table"]},
            "final_norm": {"scale": w["final_norm.scale"]},
            "superblocks": [layer]}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def token_corpus(n_seqs: int, n_tokens: int, vocab: int, *, n_topics: int,
                 zipf: float, topic_share: float, topic_boost: float,
                 seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (n_seqs, n_tokens) int32, topic (n_seqs,) int64): each topic
    multiplies the Zipf(``zipf``) weight of a random ``topic_share`` of the
    vocabulary by ``topic_boost``; every token of a sequence is drawn from
    its topic's distribution."""
    rng = np.random.default_rng([seed, 0])
    base = 1.0 / np.arange(1, vocab + 1) ** zipf
    topics = rng.integers(0, n_topics, n_seqs)
    cdf = np.empty((n_topics, vocab))
    for t in range(n_topics):
        p = base.copy()
        p[rng.choice(vocab, size=max(int(vocab * topic_share), 1),
                     replace=False)] *= topic_boost
        c = np.cumsum(p)
        cdf[t] = c / c[-1]
    u = rng.random((n_seqs, n_tokens))
    toks = np.empty((n_seqs, n_tokens), np.int32)
    for t in range(n_topics):
        rows = topics == t
        toks[rows] = np.minimum(np.searchsorted(cdf[t], u[rows], side="right"),
                                vocab - 1)
    return toks, topics


def label_mask(n_seqs: int, share: float, seed: int) -> np.ndarray:
    """Which sequences carry their topic as a label: each with
    probability ``share``."""
    return np.random.default_rng([seed, 1]).random(n_seqs) < share


def prompts(n_requests: int, batch: int, length: int, vocab: int, *,
            seed: int, device) -> torch.Tensor:
    """(n_requests, batch, length) token ids uniform over the vocabulary,
    drawn on ``device`` in one call."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, vocab, (n_requests, batch, length),
                         generator=gen, device=device)
