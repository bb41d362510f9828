"""Dry run: trace every (arch × input shape × mesh × strategy) step on the
``meta`` device and record its per-chip memory, FLOPs, bytes, collectives
and roofline terms.

Port of ``repro/launch/dryrun.py``.  Nothing is allocated and no process
group is started: the step runs on ``meta`` tensors at full width under
:func:`~repro_torch.launch.graph_analysis.analyze_step`, at full depth
or, deeper than 3 scanned super-blocks, at 1, 2 and 3 of them, read at
full depth (:func:`step_costs`); the mesh is an
:class:`~repro_torch.launch.mesh.AbstractMesh`.  The
trace does not depend on the mesh or the strategy, so :func:`run_many`
traces each (arch, shape) once and records every mesh and strategy from
it.

Per-chip FLOPs and traffic are the global trace's over ``chips``, which
assumes balanced sharding.  ``argument_bytes_per_chip`` is exact: the
local shard shapes (``sharding.specs.local_shape``) of the params,
optimizer state, batch and cache.  ``peak_live_bytes_unsharded`` is the
arguments plus the trace's peak of live bytes (an estimate where the
depth is read off cut traces);
``peak_live_bytes_per_chip_estimate`` is the per-chip arguments plus that
peak over the batch axes' size, an estimate.  Collectives are the model
of :mod:`~repro_torch.launch.graph_analysis`, not a compiler's count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single --strategy dp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, config_for_shape
from repro_torch.launch import graph_analysis
from repro_torch.launch.inputs import input_specs, step_inputs
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     production_mesh)
from repro_torch.sharding import specs as sh

__all__ = ["scanned", "with_scanned", "step_costs", "trace", "record",
           "run_one", "run_many", "main"]


def scanned(cfg) -> int:
    """The config's scanned super-blocks (all, less a dense first one)."""
    return cfg.n_superblocks - (1 if cfg.first_layer_dense else 0)


def with_scanned(cfg, n: int):
    """``cfg`` cut (or grown) to n scanned super-blocks."""
    first = 1 if cfg.first_layer_dense else 0
    return dataclasses.replace(
        cfg, n_layers=(n + first) * len(cfg.block_pattern))


def step_costs(cfg, shape, *, ssl: bool = True) -> graph_analysis.StepCosts:
    """The step's costs at ``cfg``'s depth.  Up to 3 scanned super-blocks
    the step is traced as it is; deeper, it is traced with 1, 2 and 3 and
    the costs are read at the full depth n off those traces.  The scanned
    super-blocks are identical, so FLOPs, kernel operations and ops grow
    by the same amount a block, and traffic also by a term in n² (the
    backward of each block's slice of a stacked leaf writes a gradient of
    the whole (n, ...) leaf): the parabola through the three traces gives
    each exactly.  The peak of live bytes is read off the line through
    depths 2 and 3, an estimate (``tests/test_torch_launch.py`` holds all
    of it to a full trace)."""
    n = scanned(cfg)

    def at(depth):
        spec = step_inputs(with_scanned(cfg, depth), shape, production_mesh(),
                           ssl=ssl)
        return graph_analysis.analyze_step(spec["fn"], *spec["args"])

    if n <= 3:
        return at(n)
    runs = [at(1), at(2), at(3)]
    # Lagrange weights of the depths 1, 2, 3 at n.
    coef = [(n - 2) * (n - 3) // 2, -(n - 1) * (n - 3), (n - 1) * (n - 2) // 2]

    def mix(get):
        return sum(c * get(x) for c, x in zip(coef, runs))

    names = sorted({k for x in runs for k in x.kernel_ops})
    peaks = [x.peak_live_bytes for x in runs]
    return dataclasses.replace(
        runs[0], flops=mix(lambda x: x.flops),
        traffic_bytes=mix(lambda x: x.traffic_bytes),
        kernel_ops={k: mix(lambda x: x.kernel_ops.get(k, 0.0))
                    for k in names},
        peak_live_bytes=peaks[2] + (n - 3) * (peaks[2] - peaks[1]),
        n_ops=mix(lambda x: x.n_ops))


def trace(arch: str, shape_name: str, *, ssl: bool = True) -> dict:
    """Trace one (arch, shape) step on ``meta`` tensors (:func:`step_costs`):
    its costs (no collectives) and the seconds the traces took."""
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    t0 = time.perf_counter()
    costs = step_costs(cfg, shape, ssl=ssl)
    return {"arch": arch, "shape": shape_name, "ssl": ssl, "costs": costs,
            "trace_s": time.perf_counter() - t0}


def _mesh_name(mesh) -> str:
    dims = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    if mesh == production_mesh(multi_pod=True):
        return f"multi_pod_{dims}"
    if mesh == production_mesh():
        return f"single_pod_{dims}"
    return f"mesh_{dims}"


def _local_bytes(spec_tree: dict, arg, mesh) -> int:
    return sum(math.prod(sh.local_shape(tuple(t.shape), spec_tree[path],
                                        mesh)) * t.element_size()
               for path, t in sh.tree_paths(arg))


def record(traced: dict, mesh, strategy: str) -> dict:
    """The roofline record of a :func:`trace` on ``mesh`` under
    ``strategy``."""
    arch, shape_name = traced["arch"], traced["shape"]
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    spec = input_specs(arch, shape_name, mesh, strategy, ssl=traced["ssl"])
    chips = math.prod(mesh.shape.values())
    named = dict(zip(spec["specs"], spec["args"]))
    arg_chip = sum(_local_bytes(spec["specs"][name], arg, mesh)
                   for name, arg in named.items())
    arg_all = sum(t.numel() * t.element_size() for arg in named.values()
                  for _, t in sh.tree_paths(arg))
    costs = traced["costs"]

    # Tokens a chip holds: the batch's local rows times the tokens a row.
    ba = sh.batch_axes(mesh)
    bn = math.prod(mesh.shape[a] for a in ba)
    B = shape.global_batch
    rows = B // bn if B % bn == 0 and B >= bn else B
    per_row = shape.seq_len if shape.kind != "decode" else 1
    by_op, count_by_op = graph_analysis.collective_costs(
        named["params"], spec["specs"]["params"], mesh, strategy,
        train=shape.kind == "train", act_tokens=rows * per_row,
        d_model=cfg.d_model, act_itemsize=2 if cfg.dtype == "bfloat16" else 4)
    coll = sum(by_op.values())
    flops_chip = costs.flops / chips
    traffic_chip = costs.traffic_bytes / chips
    terms = graph_analysis.roofline_terms(
        flops_chip, traffic_chip, coll, chips=1, peak_flops=PEAK_FLOPS_BF16,
        hbm_bw=HBM_BW, ici_bw=LINK_BW)

    # Useful-FLOPs reference: 6·N_active·D for train, 2·N_active·B for decode.
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    if shape.kind == "train":
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * tokens
    model_flops_per_chip = model_flops / chips
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
        "strategy": strategy, "chips": int(chips), "status": "ok",
        "trace_s": round(traced["trace_s"], 3),
        # Per chip: the global trace over chips (balanced sharding).
        "flops_per_chip": flops_chip,
        "traffic_bytes_per_chip": traffic_chip,
        "collective_bytes_per_chip": coll,
        "collectives": {"bytes_by_op": by_op, "count_by_op": count_by_op,
                        "source": "model (graph_analysis docstring)"},
        "kernel_ops": costs.kernel_ops,
        "ops_traced": costs.n_ops,
        "roofline": terms,
        "model_flops_global": model_flops,
        "useful_flops_ratio": ((model_flops_per_chip / flops_chip)
                               if flops_chip else None),
        "argument_bytes_per_chip": arg_chip,
        "peak_live_bytes_unsharded": arg_all + costs.peak_live_bytes,
        "peak_live_bytes_per_chip_estimate": (
            arg_chip + costs.peak_live_bytes / bn),
        "params_total": cfg.param_count(),
        "params_active": n_active,
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            strategy: str = "fsdp_tp", ssl: bool = True,
            mesh=None) -> dict:
    """Trace and record one combination (``mesh`` defaults to the
    production mesh ``multi_pod`` names)."""
    mesh = mesh or production_mesh(multi_pod=multi_pod)
    return record(trace(arch, shape_name, ssl=ssl), mesh, strategy)


def _safe_record(traced: dict, arch: str, shape_name: str, mesh,
                 strategy: str, ssl: bool) -> dict:
    """:func:`record` of the combination, tracing its (arch, shape) into
    ``traced`` once; a failure becomes a ``status: "error"`` record."""
    try:
        key = (arch, shape_name, ssl)
        if key not in traced:
            traced[key] = trace(arch, shape_name, ssl=ssl)
        return record(traced[key], mesh, strategy)
    except Exception as e:  # noqa: BLE001 — record the failure, go on
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
                "strategy": strategy, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def run_many(combos, *, ssl: bool = True) -> list[dict]:
    """Records of ``(arch, shape, mesh, strategy)`` combos, each (arch,
    shape) traced once.  A combination that fails is recorded with
    ``status: "error"`` and the others go on."""
    traced: dict = {}
    return [_safe_record(traced, *combo, ssl) for combo in combos]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--strategy", default="fsdp_tp", choices=sh.STRATEGIES)
    ap.add_argument("--no-ssl", action="store_true",
                    help="trace the supervised-only step (paper baseline)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for both meshes")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.all else [args.mesh]
    archs = ARCH_IDS if args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    traced: dict = {}
    for a in archs:
        for s in shapes:
            for m in meshes:
                tag = f"{a}__{s}__{m}__{args.strategy}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[run ] {tag}", flush=True)
                rec = _safe_record(traced, a, s,
                                   production_mesh(multi_pod=m == "multi"),
                                   args.strategy, not args.no_ssl)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" trace={rec['trace_s']}s "
                             f"dominant={r['dominant']}"
                             f" compute={r['compute_s']:.4f}s"
                             f" mem={r['memory_s']:.4f}s"
                             f" coll={r['collective_s']:.4f}s")
                print(f"[{rec['status']}] {tag}{extra}", flush=True)
            traced.clear()      # one (arch, shape) at a time

if __name__ == "__main__":
    main()
