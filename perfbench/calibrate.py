"""Readings that the limits of a cell's comparison are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 4,5,6] \
        [--seconds 1]

runs the cell once a seed in one process (a short window of ``--seconds``)
and prints one JSON line a run: the numbers its comparison gives for the
program (sound runs), for the control (the reference in float8 in the
program's place, on ``--control-seeds``) and for each planted fault (on
``--fault-seeds``).  ``perfbench/limits/<name>.json`` is set between the
largest sound reading and the smallest control or fault reading, as
PERF.md records.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run
    from perfbench.harness import spec
    run.caches_in_checkout()
    from repro_torch.device import resolve_device
    device = resolve_device("cuda")
    cell = spec.load_cell(args.workload, ROOT)
    plan = [(s, (), s in args.control_seeds) for s in args.seeds]
    plan += [(s, (), True) for s in args.control_seeds
             if s not in args.seeds]
    plan += [(s, (f,), False) for f in args.fault for s in args.fault_seeds]
    for seed, faults, control in plan:
        out = run.run_cell(cell, seed=seed, seconds=args.seconds,
                           trace=False, device=device,
                           t_process=time.perf_counter(), faults=faults,
                           control=control)
        rec = {"workload": args.workload, "seed": seed,
               "fault": faults[0] if faults else None,
               "numbers": out["numbers"],
               "control_numbers": out.get("control_numbers"),
               "look": out.get("look"), "metrics": out["metrics"]}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
