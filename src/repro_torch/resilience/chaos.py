"""End-to-end chaos driver: one seeded run, faults at every site.

``run_chaos`` builds the reference's small but real experiment — the
``async_ps`` parameter server (k = 3 workers), the streaming meta-batch
pipeline with per-epoch re-partitioning, the non-finite guard, a
checkpoint every epoch — and drives it through a fault plan that hits all
five injection sites:

  * a NaN- and an inf-poisoned batch (the guard must skip exactly those
    steps),
  * a staging crash and a hang (supervisor retry and watchdog),
  * a replan failure (supervisor retry; the degrade path stays bit-stable),
  * a corrupted checkpoint — the one LATEST points at (resume must fall
    back to the newest valid checkpoint),
  * a dead async worker (its age pushed past ``max_staleness``;
    ``drop_overstale`` must zero its gradient and renormalize the others).

Three phases prove the recovery contract:

  A. *uninterrupted* — the full plan, epochs 0..n-1 straight through;
  B. *interrupted*   — a fresh injector with the same plan, stopped right
     after the corrupted checkpoint is written;
  C. *resume*        — a fresh injector with the same plan again,
     ``resume=True``: LATEST's target is corrupt, the engine falls back one
     checkpoint and replays, re-firing the replayed epochs' events, to the
     same final epoch.

The report is ``ok`` when every phase completes, every site fired, the
guard's skipped-step count equals the planned poisoned batches, and phase
C's final parameters equal phase A's bit for bit.  The plan's coordinates
are the reference's (chunks of ``scan_chunk`` steps for the prefetch and
worker sites), so the same seed fires the same faults at the same steps.

CLI::

    python -m repro_torch.resilience.chaos --seed 7 --report CHAOS_report.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

from repro_torch.resilience.faults import FaultEvent, FaultInjector, FaultPlan

__all__ = ["chaos_config", "chaos_plan", "run_chaos", "main"]

N_EPOCHS = 4
CORRUPT_AT = 2          # checkpoint (completed-epoch count) to corrupt


def chaos_config(workdir: str, *, seed: int = 7):
    """The chaos experiment: small corpus, async_ps k=3, streaming
    re-partitioning every epoch, guard + checksums + drop_overstale on,
    a checkpoint every epoch, supervised retries with a hang watchdog."""
    from repro_torch.api import (BatchConfig, DataConfig, ExecutionConfig,
                                 ExperimentConfig, ObjectiveConfig,
                                 RepartitionConfig, ResilienceConfig,
                                 TrainConfig)
    return ExperimentConfig(
        name="chaos",
        data=DataConfig(n=400, n_classes=8, input_dim=32, manifold_dim=6,
                        label_ratio=0.2, test_fraction=0.0, seed=seed),
        batch=BatchConfig(pipeline="metabatch_stream", batch_size=64),
        repartition=RepartitionConfig(every_n_epochs=1, seed=seed),
        objective=ObjectiveConfig(pairwise="ref"),
        train=TrainConfig(n_epochs=N_EPOCHS, n_workers=3, dropout=0.0,
                          seed=seed),
        execution=ExecutionConfig(strategy="async_ps", scan_chunk=2,
                                  prefetch=2, max_staleness=2,
                                  checkpoint_every=1,
                                  checkpoint_dir=workdir),
        resilience=ResilienceConfig(nonfinite_guard=True,
                                    checkpoint_checksums=True,
                                    max_retries=2, backoff_base=0.0,
                                    backoff_max=0.0, hang_timeout=0.25,
                                    drop_overstale=True, seed=seed))


def chaos_plan(seed: int, *, steps_per_epoch: int,
               chunks_per_epoch: int) -> FaultPlan:
    """≥1 event per site, coordinates a pure function of ``seed``.  The
    corrupted checkpoint is pinned at ``CORRUPT_AT`` (so the resume phase
    has both a corrupt LATEST target and epochs left to replay); other
    coordinates are drawn from the run grid."""
    rng = np.random.default_rng([int(seed), 0xC4A05])

    def ep(lo=0):   # an epoch with training still ahead of it
        return int(rng.integers(lo, N_EPOCHS))

    candidates = (
        FaultEvent("batch", epoch=ep(), step=int(
            rng.integers(0, steps_per_epoch)), mode="nan"),
        FaultEvent("batch", epoch=ep(), step=int(
            rng.integers(0, steps_per_epoch)), mode="inf"),
        FaultEvent("prefetch", epoch=ep(), step=int(
            rng.integers(0, chunks_per_epoch)), mode="crash"),
        FaultEvent("prefetch", epoch=ep(), step=int(
            rng.integers(0, chunks_per_epoch)), mode="hang", arg=0.6),
        FaultEvent("replan", epoch=ep(lo=1), mode="fail"),
        FaultEvent("checkpoint", epoch=CORRUPT_AT, mode="truncate"),
        FaultEvent("worker", epoch=ep(), step=int(
            rng.integers(0, chunks_per_epoch)), mode="dead",
            worker=int(rng.integers(0, 3))),
    )
    # Same-site draws can collide on (epoch, step) — shift deterministically
    # to the next free step so any seed yields a valid (unique-key) plan.
    grids = {"batch": steps_per_epoch, "prefetch": chunks_per_epoch}
    seen, events = set(), []
    for e in candidates:
        while e.key() in seen:
            g = grids.get(e.site, 1)
            e = dataclasses.replace(
                e, step=(e.step + 1) % g,
                epoch=e.epoch if g > 1 else e.epoch % N_EPOCHS + 1)
        seen.add(e.key())
        events.append(e)
    return FaultPlan(events=tuple(events))


def _run_phase(cfg, plan, *, shared, device, n_epochs=None, resume=False):
    """One experiment run with a fresh injector armed from ``plan`` (so
    resume replays re-fire the replayed epochs' events identically)."""
    from repro_torch.api import Experiment
    if n_epochs is not None or resume:
        cfg = dataclasses.replace(
            cfg,
            train=dataclasses.replace(
                cfg.train, n_epochs=n_epochs or cfg.train.n_epochs),
            execution=dataclasses.replace(cfg.execution, resume=resume))
    injector = FaultInjector(plan)
    result = Experiment(cfg, injector=injector, device=device,
                        **shared).run()
    return result, injector


def _params_equal(a, b) -> bool:
    from repro_torch.convert import to_numpy
    from repro_torch.core.ssl_loss import tree_leaves
    leaves_a, leaves_b = tree_leaves(to_numpy(a)), tree_leaves(to_numpy(b))
    return len(leaves_a) == len(leaves_b) and all(
        np.array_equal(x, y) for x, y in zip(leaves_a, leaves_b))


def run_chaos(seed: int = 7, *, workdir: str | None = None,
              device: str = "cuda") -> dict:
    """Run the three phases on ``device``; return the machine-readable
    chaos report."""
    from repro_torch.api import Experiment

    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="chaos-")
        workdir = tmp.name
    try:
        dir_a = os.path.join(workdir, "uninterrupted")
        dir_b = os.path.join(workdir, "interrupted")
        cfg_a = chaos_config(dir_a, seed=seed)
        # Build data/graph/plan once and share across phases: phase
        # equality must come from determinism of the training stack, not
        # from comparing different corpora.
        base = Experiment(cfg_a, device=device).build()
        shared = {"corpus": base.corpus, "eval_data": base.eval_data,
                  "graph": base.graph, "plan": base.plan,
                  "hierarchy_cache": base.hierarchy_cache}
        steps = base.plan.n_meta            # async_ps: 1-worker batches
        chunks = -(-steps // cfg_a.execution.scan_chunk)
        plan = chaos_plan(seed, steps_per_epoch=steps,
                          chunks_per_epoch=chunks)

        res_a, inj_a = _run_phase(cfg_a, plan, shared=shared, device=device)
        cfg_b = chaos_config(dir_b, seed=seed)
        res_b, inj_b = _run_phase(cfg_b, plan, shared=shared, device=device,
                                  n_epochs=CORRUPT_AT)
        res_c, inj_c = _run_phase(cfg_b, plan, shared=shared, device=device,
                                  resume=True)

        planned_skips = sum(1 for e in plan.events if e.site == "batch")
        skipped_a = int(res_a.history[-1]["guard/skipped_total"])
        skipped_c = int(res_c.history[-1]["guard/skipped_total"])
        bit_identical = _params_equal(res_a.params, res_c.params)
        all_sites_fired = set(
            f["site"] for f in inj_a.fired()) == set(
            e.site for e in plan.events)
        report = {
            "seed": seed,
            "device": str(base.device),
            "plan": plan.to_json(),
            "phases": {
                "uninterrupted": {"epochs": len(res_a.history),
                                  "fired": inj_a.fired(),
                                  "skipped_total": skipped_a},
                "interrupted": {"epochs": len(res_b.history),
                                "fired": inj_b.fired()},
                "resume": {"epochs": len(res_c.history),
                           "fired": inj_c.fired(),
                           "skipped_total": skipped_c},
            },
            "planned_poisoned_batches": planned_skips,
            "all_sites_fired": all_sites_fired,
            "skip_counts_match": (skipped_a == planned_skips
                                  and skipped_c == planned_skips),
            "resume_bit_identical": bit_identical,
        }
        report["ok"] = bool(all_sites_fired
                            and report["skip_counts_match"]
                            and bit_identical
                            and len(res_a.history) == N_EPOCHS
                            and len(res_c.history) == N_EPOCHS)
        return report
    finally:
        if tmp is not None:
            tmp.cleanup()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience.chaos",
        description="Seeded chaos run: inject faults at every site, "
                    "assert recovery + bit-identical corrupt-resume.")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--report", default="CHAOS_report.json")
    parser.add_argument("--workdir", default=None,
                        help="checkpoint scratch dir (default: a tempdir)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    report = run_chaos(args.seed, workdir=args.workdir, device=args.device)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    fired = sum(len(p["fired"]) for p in report["phases"].values())
    print(f"chaos seed={args.seed} on {report['device']}: {fired} faults "
          f"fired across {len(report['plan'])} planned sites; "
          f"skip_counts_match={report['skip_counts_match']} "
          f"resume_bit_identical={report['resume_bit_identical']} "
          f"-> {args.report}")
    if not report["ok"]:
        print("chaos run FAILED acceptance checks", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
