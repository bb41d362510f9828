"""Batched serving: prefill a batch of prompts, then decode token by token.

    PYTHONPATH=src python -m repro_torch.serve.serve_lm
    PYTHONPATH=src python -m repro_torch.serve.serve_lm --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.serve.serve_lm --prompt-len 2048 \
        --spans spans.json

The port's counterpart of ``examples/serve_lm.py``.  It serves any
architecture of :mod:`repro_torch.configs` (default ``qwen2-1.5b``) at its
full width on the card, with weights drawn from ``--seed`` (no checkpoint
is loaded); ``--reduced`` serves the CPU-sized variant the reference demo
always uses.  A config with ``modality_tokens`` (the VLM) is given
(batch, modality_tokens, modality_dim) embeddings in the config's dtype,
drawn from the same seed, the shapes of the reference's
``launch/inputs.py``.  The prefill runs every causal self-attention on
K11 whose window, if it has one, covers the prompt; MoE layers route
every assignment (the dropless dispatch: K12, grouped expert products,
K13), in the prefill and in every decode step.  The decode loop then
feeds the last prompt token at position ``prompt_len − 1`` and each
sampled token after it, as the reference demo does, against a cache of
``prompt_len + steps`` slots.
Prints the parameter count of the drawn tree, the prefill's ms, the
decode's ms per token and tokens per second.  ``--device`` defaults to
``cuda`` and fails without a GPU.

``--spans PATH`` then serves :data:`SPAN_REQUESTS` more requests (the
prefill and its greedy first token, copied to the host) after one that
warms up, inside :func:`repro_torch.spans.recording` and with no
profiler, so that the host's times are free of the profiler's cost;
it writes their spans to PATH as JSON and prints, per span name, the
median over the requests of its host self-time (its host time less its
children's) and of its device time, in ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from .. import spans
from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import transformer as tf
from ..models.config import ModelConfig
from .decode import sample_tokens, serve_step

#: Requests that ``--spans`` records, after one that warms up.
SPAN_REQUESTS = 8


def load_model(cfg: ModelConfig, *, seed: int,
               device: torch.device) -> dict:
    """Params of ``cfg`` drawn on ``device`` from a generator seeded with
    ``seed``."""
    return tf.init_params(cfg,
                          torch.Generator(device=device).manual_seed(seed))


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, *,
                 seed: int, device: torch.device) -> torch.Tensor:
    """(batch, prompt_len) token ids, uniform over the vocabulary."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def make_modality(cfg: ModelConfig, batch: int, *, seed: int,
                  device: torch.device) -> torch.Tensor | None:
    """(batch, modality_tokens, modality_dim) standard normal embeddings in
    the config's dtype for a config with a modality front end, else
    None."""
    if not cfg.modality_tokens:
        return None
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    return torch.randn((batch, cfg.modality_tokens, cfg.modality_dim),
                       generator=gen, device=device).to(getattr(torch,
                                                                cfg.dtype))


def param_count(params) -> int:
    """Parameters in the drawn tree (``ModelConfig.param_count`` is the
    reference's analytic count, which differs for some families)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


def prefill(params: dict, cfg: ModelConfig, prompts: torch.Tensor,
            steps: int, modality: torch.Tensor | None = None):
    """The prompts' logits (and a MoE model's routing records, ``"moe"``)
    and the cache, ``prompt_len + steps`` slots; MoE layers dropless."""
    return tf.prefill(params, cfg, prompts, modality_embeds=modality,
                      cache_len=prompts.shape[1] + steps,
                      moe_dispatch="dropless")


def decode(params: dict, cfg: ModelConfig, cache: dict,
           prompts: torch.Tensor, steps: int, *, temperature: float,
           generator: torch.Generator | None = None):
    """``steps`` calls of ``serve_step`` after the prefill, MoE layers
    dropless -> ((B, steps) tokens, cache)."""
    B, T = prompts.shape
    cur, toks = prompts[:, -1:], []
    for s in range(steps):
        pos = torch.full((B,), T + s - 1, dtype=torch.int32,
                         device=prompts.device)
        cur, cache = serve_step(params, cfg, cache, cur, pos, generator,
                                temperature=temperature,
                                moe_dispatch="dropless")
        toks.append(cur)
    return torch.cat(toks, dim=1), cache


def span_table(records: list[dict]) -> dict:
    """span name -> {"host_ms", "host_self_ms", "device_ms", "count"}: per
    request, the sums over the name's spans of their host time, of it less
    their children's, and of their device intervals (0 without one), and
    their number; the median of each over the requests."""
    children: dict = {}
    for r in records:
        children[r["parent"]] = children.get(r["parent"], 0.0) + (
            r["end"] - r["start"])
    per: dict = {}
    for r in records:
        row = per.setdefault(r["name"], {}).setdefault(r["req"],
                                                       [0.0, 0.0, 0.0, 0])
        row[0] += r["end"] - r["start"]
        row[1] += r["end"] - r["start"] - children.get(r["id"], 0.0)
        if r["dev"]:
            row[2] += r["dev"][1] - r["dev"][0]
        row[3] += 1
    keys = ("host_ms", "host_self_ms", "device_ms", "count")
    return {name: {k: (1e3 if j < 3 else 1) * statistics.median(
                       v[j] for v in reqs.values())
                   for j, k in enumerate(keys)}
            for name, reqs in per.items()}


def record_spans(params: dict, cfg: ModelConfig, prompts: torch.Tensor,
                 steps: int, modality: torch.Tensor | None,
                 path: Path) -> dict:
    """Serve SPAN_REQUESTS requests after a warm-up one inside
    ``spans.recording()``, write their spans to ``path`` and print the
    :func:`span_table` of them -> that table."""
    def request():
        out, _ = prefill(params, cfg, prompts, steps, modality)
        sample_tokens(out["logits"][:, -1:])[:, 0].cpu()

    request()
    spans.clear()
    with spans.recording():
        for _ in range(SPAN_REQUESTS):
            request()
    recs = spans.records()
    spans.clear()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(recs))
    table = span_table(recs)
    print(f"spans of {SPAN_REQUESTS} requests (medians, ms): {path}")
    print(f"  {'span':<24}{'count':>7}{'host':>10}{'host self':>11}"
          f"{'device':>10}")
    for name, row in sorted(table.items(), key=lambda kv:
                            -kv[1]["host_self_ms"]):
        print(f"  {name:<24}{row['count']:>7g}{row['host_ms']:>10.3f}"
              f"{row['host_self_ms']:>11.3f}{row['device_ms']:>10.3f}")
    return table


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="0 for greedy decoding")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU-sized variant (ModelConfig.reduced)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--spans", type=Path, default=None, metavar="PATH",
                    help="then record the program spans of "
                    f"{SPAN_REQUESTS} requests into this JSON file and "
                    "print host self-time and device time per span name")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = load_model(cfg, seed=args.seed, device=device)
    print(f"serving {cfg.name} ({param_count(params) / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) on "
          f"{device}")
    prompts = make_prompts(cfg, args.batch, args.prompt_len, seed=args.seed,
                           device=device)
    modality = make_modality(cfg, args.batch, seed=args.seed, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    _sync(device)
    t0 = time.perf_counter()
    _, cache = prefill(params, cfg, prompts, args.steps, modality)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    out, _ = decode(params, cfg, cache, prompts, args.steps,
                    temperature=args.temperature, generator=gen)
    _sync(device)
    decode_s = time.perf_counter() - t0
    stats = {"prefill_ms": 1e3 * prefill_s,
             "decode_ms_per_token": 1e3 * decode_s / max(args.steps, 1),
             "tok_per_s": args.batch * args.steps / decode_s}
    print(f"prefill: batch={args.batch} len={args.prompt_len} "
          f"{stats['prefill_ms']:.3f} ms")
    print(f"decode: {args.steps} tokens/seq, {stats['decode_ms_per_token']:.3f}"
          f" ms/token, {stats['tok_per_s']:.1f} tok/s")
    if device.type == "cuda":
        stats["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"peak device memory {stats['peak_mem_gb']:.3f} GB on "
              f"{torch.cuda.get_device_name(device)}")
    for b in range(args.batch):
        print(f"  seq{b}: {out[b].tolist()}")
    if args.spans is not None:
        stats["spans"] = record_spans(params, cfg, prompts, args.steps,
                                      modality, args.spans)
    return stats


if __name__ == "__main__":
    main()
