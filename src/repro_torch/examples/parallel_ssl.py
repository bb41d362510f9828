"""Data-parallel SSL training across k workers (paper §2.3 / Fig. 3b).

Driven end to end by :mod:`repro_torch.api` through the engine;
``--strategy`` picks the STRATEGY registry entry by name:

  * ``sync_mesh``  — each of R ranks takes k/R workers of every batch, and
    the gradients are gathered and summed in rank order, with the paper's
    lr = 0.001·k rule.  Run alone it is one rank (R = 1); under
    ``torchrun --nproc_per_node R`` on a machine with R GPUs each process
    is one rank on its own GPU (NCCL; gloo with ``--device cpu``);
  * ``async_ps``   — the §4 stale-gradient parameter-server regime;
  * ``sequential`` — the k-worker step on one device.

    python -m repro_torch.examples.parallel_ssl --workers 4 --epochs 6
    python -m repro_torch.examples.parallel_ssl --workers 4 --strategy async_ps
    torchrun --nproc_per_node 2 -m repro_torch.examples.parallel_ssl --workers 4
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--strategy", default="sync_mesh",
                    choices=["sequential", "sync_mesh", "async_ps"])
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="steps per chunk, the fault sites' and guard "
                         "windows' unit (0 = the whole epoch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.api import (BatchConfig, DataConfig, Experiment,
                                 ExecutionConfig, ExperimentConfig,
                                 ObjectiveConfig, TrainConfig)

    device = args.device
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:
        # torchrun: one rank a process, its address in the environment.
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local)
            device = f"cuda:{local}"
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    rank = dist.get_rank() if launched else 0
    k = args.workers
    cfg = ExperimentConfig(
        name=f"parallel-{k}w-{args.strategy}",
        data=DataConfig(n=4000, n_classes=16, input_dim=128, manifold_dim=10,
                        label_ratio=0.05),          # the paper's 5% scenario
        batch=BatchConfig(batch_size=256),
        objective=ObjectiveConfig(gamma=1.0, kappa=1e-4, weight_decay=1e-5),
        train=TrainConfig(n_epochs=args.epochs, n_workers=k,
                          base_lr=1e-3, lr_reset_epochs=10, dropout=0.0,
                          hidden_dim=512, n_hidden=3),
        execution=ExecutionConfig(strategy=args.strategy,
                                  scan_chunk=args.scan_chunk))
    try:
        if rank == 0:
            if args.strategy == "sync_mesh":
                R = dist.get_world_size() if launched else 1
                print(f"{k} workers over {R} rank(s), {k // R} each; lr "
                      f"rule: 0.001*{k} for 10 epochs, then 0.001")
            elif args.strategy == "async_ps":
                print(f"{k} async workers pushing stale gradients "
                      "(max_staleness=2, round-robin server)")
        res = Experiment(cfg, device=device).run()
        if rank == 0:
            for row in res.history:
                print(f"epoch {row['epoch']}: lr={row['lr']:.4f} "
                      f"loss={row['loss/total']:.4f} "
                      f"val_acc={row['eval/acc']:.4f}")
            print(f"done in {res.seconds:.1f}s on {device}")
    finally:
        if launched:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
