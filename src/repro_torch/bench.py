"""Measurements of the port on the GPU: the paper's configuration, kernel
timing from CUDA graphs and with CUDA events, and profiled training steps.

    PYTHONPATH=src python -m repro_torch.bench [--steps 5] [--out DIR]
                                               [--layout-bt 128]
    PYTHONPATH=src python -m repro_torch.bench --lm [--steps 2]

builds the paper's configuration (4×2000 DNN, 351→39, batch 1024, 20k
nodes), stages one real batch and runs ``--steps`` training steps under
``torch.profiler`` after a warm-up; ``--layout-bt`` gives the batches a
block layout, so the step runs the block-sparse kernels K4–K6.  It prints
one JSON line with the device time per step by kernel group (dense
matmuls, the graph-regularizer kernels, everything else), the device's
busy share of the profiled window, and the host's batch-assembly and
staging times; the full kernel table goes to ``DIR/step_profile.txt``
(``step_profile_bt<N>.txt`` with a layout).  The serve path has its own
record: ``python -m repro_torch.serve.serve_lm --spans PATH`` (the
program's spans, host and device time by span) and the benchmark's
traced runs (``perfbench/``).  ``--lm`` profiles ``--steps``
steps of the LM training path after a warm-up one
(:func:`profile_lm_train`: ``qwen2-1.5b`` at full width and depth, 16
sequences of 4,096 tokens a step, the sequence-level SSL term on K1/K2):
device time by group (matmuls, the regularizer's kernels, everything
else), the device's busy share and the peak device memory; the kernel
table goes to ``DIR/lm_train_profile.txt``.  Needs a GPU;
``chip_smoke.py`` imports :func:`paper_config`, :func:`lm_train_setup`,
:func:`time_ms` and :func:`graph_ms` from here.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

__all__ = ["paper_config", "lm_train_setup", "time_ms", "graph_ms",
           "profile_step", "profile_lm_train"]

#: Names of this package's kernels in a profiler trace: K1–K3 and the
#: block-sparse K4–K7, with the second pass of K1 and K4, the two passes
#: of K1's class-split plan and the class padding of the inputs of K1, K2,
#: K4 and K6.
REG_KERNELS = ("pad_classes", "reg_fwd_partials", "reg_fwd_tree_sum",
               "reg_fwd_class_partials", "reg_fwd_class_sum",
               "reg_bwd_dlogp", "reg_bwd_dw", "bsp_fwd_partials",
               "bsp_bwd_bterm", "bsp_bwd_dlogp", "bsp_bwd_dw")


def paper_config(n_epochs: int = 1, layout_bt: int | None = None,
                 construction: str = "host"):
    """The paper's TIMIT-width setup (§3) on the synthetic corpus; with
    ``layout_bt`` the batches carry a block layout of that tile edge and
    the regularizer runs on the block-sparse kernels; ``construction=
    "device"`` builds the k-NN graph on the streaming top-k kernel K8."""
    from repro_torch.api import (BatchConfig, DataConfig, ExperimentConfig,
                                 GraphConfig, ObjectiveConfig, TrainConfig)
    return ExperimentConfig(
        name="paper_4x2000",
        data=DataConfig(n=20000, n_classes=39, input_dim=351,
                        manifold_dim=12),
        graph=GraphConfig(construction=construction),
        objective=ObjectiveConfig(gamma=1.0, kappa=1e-4, pairwise="auto"),
        train=TrainConfig(hidden_dim=2000, n_hidden=4, dropout=0.2,
                          n_epochs=n_epochs),
        batch=BatchConfig(batch_size=1024, layout_bt=layout_bt))


#: The LM training configuration: ``train_4k``'s sequence length with its
#: global batch of 256 cut to one card's 16 sequences (meta-batches of 8,
#: each concatenated with a sampled neighbour), one SSL group a step.
LM_TRAIN = {"arch": "qwen2-1.5b", "seq_len": 4096, "batch": 8}


def lm_train_setup(device, *, seed: int = 0) -> dict:
    """What an LM training run of :data:`LM_TRAIN` starts from: the config,
    the example's host pipeline (``examples.train_lm_ssl.build_data``:
    512 sequences, bag-of-tokens k-NN graph, meta-batch plan), params
    drawn on ``device`` from ``seed``, AdaGrad and its state, and the
    example's SSL hyper-parameters."""
    from repro_torch.configs import get_config
    from repro_torch.core import SSLHyper
    from repro_torch.examples import train_lm_ssl
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adagrad

    cfg = get_config(LM_TRAIN["arch"])
    data = train_lm_ssl.build_data(cfg.vocab_size, LM_TRAIN["seq_len"],
                                   LM_TRAIN["batch"])
    params = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed))
    opt = adagrad()
    return {"cfg": cfg, "data": data, "params": params, "opt": opt,
            "state": opt.init(params),
            "hyper": SSLHyper(gamma=0.05, kappa=1e-4, weight_decay=0.0)}


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


def graph_ms(fn, n: int | None = None, reps: int = 3) -> float:
    """Device time of one ``fn()`` from a CUDA graph of ``n`` back-to-back
    calls, replayed ``reps`` times between CUDA events: no host time
    between the launches, so a kernel shorter than its wrapper's Python
    and launch overhead is timed, not the host.  ``fn`` is warmed up on a
    side stream first (three calls, the last one timed); ``n`` defaults to
    the number of calls that fills about 10 ms a replay, 2 to 50.  ``fn``
    runs ``n + 3`` times, and launch counters advance by as much."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        fn()
        fn()
        start.record()
        fn()
        end.record()
    torch.cuda.current_stream().wait_stream(side)
    if n is None:
        end.synchronize()
        n = min(50, max(2, round(10.0 / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def _group(name: str) -> str:
    if any(k in name for k in REG_KERNELS):
        return "graph_reg_kernels"
    if "flash_fwd" in name:
        return "flash_attention"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "matmul", "xmma", "nvjet")):
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
    pairwise = resolve_pairwise(cfg.objective.pairwise, tiles=exp.tiles())
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
    groups, rows = _device_rows(prof, steps)
    busy = sum(groups.values())
    result.update(profiled_wall_ms_per_step=wall_ms / steps,
                  device_ms_per_step=groups,
                  device_busy_share=busy / (wall_ms / steps) if busy else None)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        bt = cfg.batch.layout_bt
        fname = ("step_profile.txt" if bt is None
                 else f"step_profile_bt{bt}.txt")
        with open(out / fname, "w") as fh:
            fh.write(json.dumps(result) + "\n")
            for ms, calls, name in rows:
                fh.write(f"{ms:10.4f} ms/step {calls:8.1f} calls/step  "
                         f"{name}\n")
    print("top kernels (device ms per step, calls per step):")
    for ms, calls, name in rows[:12]:
        print(f"  {ms:9.4f}  {calls:6.1f}  {name[:110]}")
    return result


def _device_rows(prof, per: int) -> tuple[dict, list]:
    """Device ms by group (matmuls, this package's regularizer kernels,
    everything else) and the kernel table of a profile, each per ``per``
    steps."""
    groups = {"matmul": 0.0, "graph_reg_kernels": 0.0, "other": 0.0}
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = _group(evt.key)
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3 / per
        rows.append((dev_us / 1e3 / per, evt.count / per, evt.key))
    rows.sort(reverse=True)
    return groups, rows


def profile_lm_train(steps: int = 2, out: Path | None = None) -> dict:
    """Profile ``steps`` steps of ``lm_train_step`` on :data:`LM_TRAIN`
    after one warm-up step; each step takes its batch from the example's
    pipeline (host assembly and the copy to the card included)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    from repro_torch.examples import train_lm_ssl
    from repro_torch.train.train_step import lm_train_step

    dev = resolve_device("cuda")
    run = lm_train_setup(dev)
    batches = train_lm_ssl.batches(run["data"], LM_TRAIN["batch"],
                                   steps + 1, dev)

    def step(batch):
        lm_train_step(run["params"], run["state"], batch, cfg=run["cfg"],
                      hyper=run["hyper"], opt=run["opt"],
                      lr=train_lm_ssl.LR, pairwise="auto")

    step(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups, rows = _device_rows(prof, steps)
    busy = sum(groups.values())
    result = {"device": torch.cuda.get_device_name(0), **LM_TRAIN,
              "sequences_per_step": 2 * LM_TRAIN["batch"],
              "profiled_wall_ms_per_step": wall_ms / steps,
              "device_ms_per_step": groups,
              "device_busy_share": busy / (wall_ms / steps),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "lm_train_profile.txt", "w") as fh:
            fh.write(json.dumps(result) + "\n")
            for ms, calls, name in rows:
                fh.write(f"{ms:10.4f} ms/step {calls:8.1f} calls/step  "
                         f"{name}\n")
    print("top kernels (device ms per step, calls per step):")
    for ms, calls, name in rows[:15]:
        print(f"  {ms:9.4f}  {calls:7.1f}  {name[:110]}")
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    ap.add_argument("--layout-bt", type=int, default=None)
    ap.add_argument("--lm", action="store_true",
                    help="profile the LM training path instead")
    args = ap.parse_args(argv)
    if args.lm:
        print(json.dumps(profile_lm_train(steps=args.steps, out=args.out)))
        return
    from repro_torch.api import Experiment
    exp = Experiment(paper_config(layout_bt=args.layout_bt),
                     device="cuda").build()
    print(json.dumps(profile_step(exp, args.steps, args.out)))


if __name__ == "__main__":
    main()
