"""What one cell is: its entry in ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``perfbench/configs/<config>.json``   the model's sizes as run;
* ``perfbench/traffic/<traffic>.json``  the mix's parameters, read by the
  loop named by its ``kind`` (``perfbench/harness/<kind>.py``);
* ``perfbench/metrics/<metric>.py``     one per-layer metric's reader;
* ``perfbench/limits/<workload>.json``  the limits of the cell's
  comparison with the plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files;
    ``KeyError`` names a workload the file does not list."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_read(BENCH / "configs" / f"{w['config']}.json"),
        traffic=_read(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_read(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``perfbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
