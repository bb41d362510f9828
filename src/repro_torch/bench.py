"""Measurements of the port on the GPU: the paper's configuration, kernel
timing with CUDA events, and a profiled training step.

    PYTHONPATH=src python -m repro_torch.bench [--steps 5] [--out DIR]

builds the paper's configuration (4×2000 DNN, 351→39, batch 1024, 20k
nodes), stages one real batch and runs ``--steps`` training steps under
``torch.profiler`` after a warm-up.  It prints one JSON line with the
device time per step by kernel group (dense matmuls, the graph-regularizer
kernels, everything else), the device's busy share of the profiled window,
and the host's batch-assembly and staging times; the full kernel table goes
to ``DIR/step_profile.txt``.  Needs a GPU; ``chip_smoke.py`` imports
:func:`paper_config` and :func:`time_ms` from here.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

__all__ = ["paper_config", "time_ms", "profile_step"]

#: Names of this package's kernels in a profiler trace.
REG_KERNELS = ("reg_fwd_partials", "reg_fwd_sum", "reg_bwd_dlogp",
               "reg_bwd_dw")


def paper_config(n_epochs: int = 1):
    """The paper's TIMIT-width setup (§3) on the synthetic corpus."""
    from repro_torch.api import (BatchConfig, DataConfig, ExperimentConfig,
                                 ObjectiveConfig, TrainConfig)
    return ExperimentConfig(
        name="paper_4x2000",
        data=DataConfig(n=20000, n_classes=39, input_dim=351,
                        manifold_dim=12),
        objective=ObjectiveConfig(gamma=1.0, kappa=1e-4, pairwise="auto"),
        train=TrainConfig(hidden_dim=2000, n_hidden=4, dropout=0.2,
                          n_epochs=n_epochs),
        batch=BatchConfig(batch_size=1024))


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``n`` back-to-back calls, from CUDA
    events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _group(name: str) -> str:
    if any(k in name for k in REG_KERNELS):
        return "graph_reg_kernels"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "matmul" in low or "xmma" in low:
        return "matmul"
    return "other"


def profile_step(exp, steps: int = 5, out: Path | None = None, *,
                 trace: bool = True) -> dict:
    """Time one training step of ``exp`` (built) on one staged batch with
    CUDA events, and with ``trace`` also profile ``steps`` steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.models.dnn import DNNConfig, init_dnn
    from repro_torch.optim import adagrad
    from repro_torch.train.engine import stage_batch
    from repro_torch.train.train_step import dnn_ssl_step

    cfg = exp.config
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    host_batch = next(iter(exp.pipeline()))
    assemble_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    batch = stage_batch(host_batch, dev)
    torch.cuda.synchronize()
    stage_ms = 1e3 * (time.perf_counter() - t0)
    model = DNNConfig(input_dim=exp.corpus.X.shape[1],
                      hidden_dim=cfg.train.hidden_dim,
                      n_hidden=cfg.train.n_hidden,
                      n_classes=exp.corpus.n_classes,
                      dropout=cfg.train.dropout)
    params = init_dnn(model, cfg.train.seed, device=dev)
    opt = adagrad()
    state = opt.init(params)
    gen = torch.Generator(dev).manual_seed(0)
    pairwise = resolve_pairwise(cfg.objective.pairwise)
    hyper = cfg.objective.hyper()

    def step():
        dnn_ssl_step(params, state, batch, cfg=model, hyper=hyper, opt=opt,
                     lr=1e-3, generator=gen, dropout=cfg.train.dropout,
                     pairwise=pairwise)

    step_ms = time_ms(step, n=10, warmup=3)
    result = {
        "device": torch.cuda.get_device_name(0),
        "P": int(batch["x"].shape[1]),
        "step_ms_events": step_ms,
        "host_batch_assembly_ms": assemble_ms,
        "host_staging_ms": stage_ms,
    }
    if not trace:
        return result
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = {"matmul": 0.0, "graph_reg_kernels": 0.0, "other": 0.0}
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        groups[_group(evt.key)] += dev_us / 1e3 / steps
        rows.append((dev_us / 1e3 / steps, evt.count // steps, evt.key))
    rows.sort(reverse=True)
    busy = sum(groups.values())
    result.update(profiled_wall_ms_per_step=wall_ms / steps,
                  device_ms_per_step=groups,
                  device_busy_share=busy / (wall_ms / steps) if busy else None)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "step_profile.txt", "w") as fh:
            fh.write(json.dumps(result) + "\n")
            for ms, calls, name in rows:
                fh.write(f"{ms:10.4f} ms/step {calls:5d} calls/step  "
                         f"{name}\n")
    print("top kernels (device ms per step, calls per step):")
    for ms, calls, name in rows[:12]:
        print(f"  {ms:9.4f}  {calls:4d}  {name[:110]}")
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    args = ap.parse_args(argv)
    from repro_torch.api import Experiment
    exp = Experiment(paper_config(), device="cuda").build()
    print(json.dumps(profile_step(exp, args.steps, args.out)))


if __name__ == "__main__":
    main()
