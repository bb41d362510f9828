"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is the entry ``<name>`` of
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
metric readers are files under ``perfbench/`` found by their names.  The
run makes its inputs and weights from ``--seed``, warms up the cell's
shapes, measures for ``--seconds`` (``--trace 0``: the cell's end-to-end
metrics) or profiles a short traced window (``--trace 1``: its per-layer
metrics), then checks the timed path's outputs against the plain
reference in ``perfbench/reference``.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), with ``checks`` last.

It needs the CUDA cards the cell asks for and exits non-zero, with no
result, without them, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux: from
    /proc; elsewhere the moment this module was imported)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def caches_in_checkout() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             t_process: float, **kw) -> dict:
    """The loop of the cell's traffic kind (``harness/<kind>.py``)."""
    loop = importlib.import_module(f"perfbench.harness.{cell.traffic['kind']}")
    return loop.run(cell, seed=seed, seconds=seconds, trace=trace,
                    device=device, t_process=t_process, **kw)


def result_line(cell, out: dict, trace: bool, dev: dict) -> tuple:
    """(the last line's object without its checks, the checks) of a run
    whose loop returned ``out`` on the device described by ``dev``."""
    from perfbench.count import flops
    from perfbench.harness import common, result
    correct, checks = result.judge(out["numbers"], cell.limits)
    line = {"correct": correct, "attempted": out["attempted"], "failed": 0}
    if trace:
        ctx = dict(out["trace_ctx"], peaks=flops.peaks(dev["kind"]))
        tr = ctx["trace"]
        line["metrics"] = common.read_per_layer(cell, ctx)
        dev = dict(dev, busy_s=tr.busy_s(), window_s=tr.window_s)
        line["device"] = dev
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        line["metrics"] = {k: {"value": v, "unit": units[k]}
                           for k, v in out["metrics"].items() if k in units}
        line["device"] = dev
    return line, checks


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    caches_in_checkout()
    from perfbench.harness import common, result, spec
    setup = common.SetUp(t_process)
    cell = spec.load_cell(args.workload, ROOT)
    setup.mark("interpreter and the cell's files")

    import torch
    setup.mark("import torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    device = resolve_device("cuda")
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    setup.mark("CUDA context")

    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t_process=t_process,
                   setup=setup)

    found = result.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    dev = result.device_info(torch, cell.chips, out["peak"])
    line, checks = result_line(cell, out, bool(args.trace), dev)
    result.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
