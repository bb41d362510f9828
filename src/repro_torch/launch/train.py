"""Training launcher: ``--arch <id> --shape train_4k --sharding …``.

Port of ``repro/launch/train.py``.  ``--dry-run`` traces the production
step at full width and depth on the ``meta`` device in this process (see
:mod:`~repro_torch.launch.dryrun`; the reference needed a subprocess only
to set ``XLA_FLAGS``), while ``--smoke`` runs real steps of
``lm_train_step`` on the reduced variant through the port's ``Engine``,
with the SSL head on K1 (forward) and K2 (backward) once a step.  The
smoke runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --dry-run

``--arch`` takes several ids for ``--smoke``: each runs in turn in one
process.  The smoke prints one JSON line per architecture: its per-step
losses, kernel launches and ms/step.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["SMOKE_B", "SMOKE_T", "smoke_batches", "smoke", "main"]

SMOKE_B, SMOKE_T = 4, 32


def smoke_batches(cfg, steps: int, rng: np.random.Generator):
    """The reference smoke's batches: ``steps`` of B = 4 sequences of T =
    32 random tokens, W all ones (one group of 4), zero labels, zero
    modality embeddings for a cross-attention config."""
    B, T = SMOKE_B, SMOKE_T
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, T + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "loss_mask": np.ones((B, T), np.float32),
                 "W": np.ones((1, B, B), np.float32),
                 "seq_labels": np.zeros((1, B), np.int32),
                 "seq_label_mask": np.ones((1, B), np.float32)}
        if cfg.modality_tokens:
            batch["modality_embeds"] = np.zeros(
                (B, cfg.modality_tokens, cfg.modality_dim), np.float32)
        yield batch


def smoke(arch: str, *, steps: int = 10, scan_chunk: int = 5,
          device: str | torch.device = "cuda", params: dict | None = None,
          generator: torch.Generator | None = None,
          record: list | None = None):
    """Real steps on ``arch``'s reduced variant, through the same engine the
    SSL trainers use: one epoch of ``steps`` batches in chunks of
    ``scan_chunk``, AdaGrad at a constant 1e-3, ``SSLHyper(1e-2, 1e-3,
    0)`` on the pooled head with the ``"auto"`` regularizer (K1 and K2 on
    the card).  ``params`` (the port's nest, or the reference's initial
    params as numpy arrays) default to ``init_params`` from ``generator``
    (default: the CPU generator seeded 0), drawn on the CPU; they are
    copied to ``device``, so the card and the CPU start from the same
    params.  ``record``, when given, gets each step's metrics.  Returns
    the ``EngineResult``."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adagrad, constant_lr
    from repro_torch.train.engine import Engine, TrainState, lift_step
    from repro_torch.train.train_step import lm_train_step

    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    if params is None:
        gen = generator or torch.Generator().manual_seed(0)
        params = tf.init_params(cfg, gen, device="cpu")
    params = to_torch(params, dev)
    opt = adagrad()
    hyper = SSLHyper(1e-2, 1e-3, 0.0)
    state = TrainState(params=params, opt_state=opt.init(params))
    rng = np.random.default_rng(0)

    def update(p, o, batch, lr):
        out = lm_train_step(p, o, batch, cfg=cfg, hyper=hyper, opt=opt,
                            lr=lr, pairwise="auto")
        if record is not None:
            record.append(out[2])
        return out

    engine = Engine(lift_step(update), device=dev, strategy="sequential",
                    scan_chunk=scan_chunk, prefetch=2)
    return engine.run(lambda: smoke_batches(cfg, steps, rng), state=state,
                      n_epochs=1, lr_schedule=constant_lr(1e-3))


def _run_smoke(arch: str, args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import graph_reg
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.serve_lm import param_count

    cfg = get_config(arch).reduced()
    n = param_count(init_params(cfg, torch.Generator(), device="meta"))
    print(f"[smoke] {cfg.name}: {n / 1e6:.2f}M params")
    steps = []
    graph_reg.reset_launch_counts()
    t0 = time.perf_counter()
    res = smoke(arch, steps=args.steps, scan_chunk=args.scan_chunk,
                device=args.device, record=steps)
    total = time.perf_counter() - t0
    counts = {k: v for k, v in graph_reg.launch_counts().items() if v}
    row = res.history[-1]
    # The epoch's wall time: its batches, staging, every step and the one
    # metric fetch at its end (which waits for the device); not the
    # params' init and copy or the engine's set-up.
    dt = row["seconds"]
    losses = [float(m["loss/total"]) for m in steps]
    print(f"  {args.steps} steps in {dt:.2f}s ({args.steps / dt:.2f} "
          f"steps/s, {1e3 * dt / args.steps:.2f} ms/step over the epoch, "
          f"{total:.2f}s with the set-up; scan_chunk={args.scan_chunk}, "
          f"device {args.device}) mean loss={row['loss/total']:.4f}; "
          f"launches {counts}")
    print(f"[smoke] done — global step {res.state.step}")
    return {"arch": arch, "config": cfg.name, "params": n,
            "device": args.device, "steps": args.steps,
            "scan_chunk": args.scan_chunk, "seconds": dt,
            "seconds_with_setup": total,
            "ms_per_step": 1e3 * dt / args.steps, "losses": losses,
            "mean_loss": row["loss/total"], "launches": counts,
            "global_step": res.state.step}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, nargs="+")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--sharding", default="fsdp_tp",
                    choices=["dp", "fsdp", "fsdp_tp"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="run real steps on the reduced variant")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scan-chunk", type=int, default=5,
                    help="steps per engine chunk (0 = the epoch)")
    ap.add_argument("--ssl", action="store_true", default=True,
                    help="ignored: accepted as the reference accepts it "
                         "(on by default, with no way to turn it off); "
                         "the smoke always trains the SSL head")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the smoke only)")
    args = ap.parse_args(argv)

    if args.smoke:
        for arch in args.arch:
            print(json.dumps({"smoke": _run_smoke(arch, args)}), flush=True)
        return
    from repro_torch.launch import dryrun
    for arch in args.arch:
        rec = dryrun.run_one(arch, args.shape, multi_pod=args.multi_pod,
                             strategy=args.sharding)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
