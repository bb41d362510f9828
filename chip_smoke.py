#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``src/repro_torch/csrc`` from this
   checkout, one ``nvcc`` per source, all started together;
3. host pipeline of the paper's configuration: corpus, k-NN graph,
   partition and meta-batch plan (``Experiment.build``), which fixes the
   padded batch size P of the main path;
4. kernels: K1, K2 and K3 at the path's shape (k=1, B=P, C=39, γ=1,
   κ=1e-4, g=1/B, W a real padded affinity block), at the same shape with
   γ=0.8, κ=1e-2 and g=0.5 (so the κ and degree terms are not lost under
   the tolerance), and at a ragged shape (B=1000), each held against its
   plain PyTorch version on the card, run twice for bit-identical repeats,
   and timed with CUDA events beside its plain version and, for K3, one
   PyTorch call computing the same function;
5. small-step parity: one ``dnn_ssl_step`` with the GPU kernels against the
   same step on the CPU (plain versions), from the same params and batch;
6. main path: ``repro_torch.api.Experiment(cfg, device="cuda").run()`` at
   the paper's width (4×2000 DNN, 351→39, batch 1024) for one epoch, with
   every kernel launch counter set to 0 just before and read just after,
   and the steady ms/step timed between two synchronised points;
   K1 and K2 must launch once per step and K3 never (W needs no gradient);
   then the W-gradient path (the ``"auto"`` entry's VJP with ``W`` requiring
   a gradient, at the same shape), which must launch K1, K2 and K3 once;
7. a step breakdown (``repro_torch.bench.profile_step`` without the
   profiler): host batch assembly, staging, and one full step timed between
   CUDA events, back to back (which includes the host's launch gaps);
8. the ``{"kernels": [...]}`` line, then the result line.

Exits non-zero without a GPU or without the package beside this script.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: HBM bandwidth and f32 rate outside the tensor cores
# (the kernels are plain FMA loops in float32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

REPLACES = {
    "graph_reg_fwd": "src/repro/kernels/graph_reg.py:145 _fused_reg_forward "
                     "(kernel _fused_reg_kernel :99)",
    "graph_reg_bwd_dlogp": "src/repro/kernels/graph_reg.py:329 _reg_bwd_dlogp "
                           "(kernel _reg_bwd_dlogp_kernel :262)",
    "graph_reg_bwd_dw": "src/repro/kernels/graph_reg.py:371 _reg_bwd_dw "
                        "(kernel _reg_bwd_dw_kernel :299)",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: Kernel against plain version: elementwise |got - want| <= atol +
#: RTOL·|want| with atol = RTOL·max|want| (no floor, so outputs scaled by a
#: small g keep a relative limit).  Both sum float32 terms in other orders.
RTOL = 2e-5


def compare(name: str, got, want) -> dict:
    import torch
    err = (got - want).abs()
    atol = RTOL * float(want.abs().max())
    limit = (atol + RTOL * want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    over = float((err / limit).max())
    rec = {"max_abs_err": float(err.max()), "tol": atol, "err_over_tol": over}
    print(f"{name}: max_abs_err={rec['max_abs_err']:.3e} atol={atol:.3e} "
          f"rtol={RTOL:g} err/tol={over:.3f}")
    check(math.isfinite(over) and over <= 1.0,
          f"{name} disagrees with its plain version")
    return rec


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_all() -> None:
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    check(bool(names), f"no CUDA sources under {build.CSRC}")
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, path in zip(names, pool.map(
                lambda n: build.build(n, verbose=True), names)):
            print(f"built {name}.cu -> {path.relative_to(ROOT)}")
    print(f"build: {len(names)} source(s) in {time.time() - t0:.1f}s")


def kernel_inputs(B: int, C: int, W_np, seed: int, g: float | None = None):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (2.0 * rng.standard_normal((1, B, C))).astype(np.float32)).cuda()
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    W = torch.from_numpy(np.ascontiguousarray(W_np, np.float32)[None]).cuda()
    g = torch.full((1,), 1.0 / B if g is None else g, dtype=torch.float32,
                   device="cuda")
    return logp, W, g


def real_block(exp, P: int):
    """A padded affinity block as the main path builds it: two meta-batches
    of the plan, concatenated, zero-padded to P."""
    import numpy as np
    plan = exp.plan
    idx = np.concatenate([plan.meta_batches[0], plan.meta_batches[1]])[:P]
    W = np.zeros((P, P), np.float32)
    W[:len(idx), :len(idx)] = exp.graph.dense_block(idx)
    return W


def kernel_phase(W_path, gamma: float, kappa: float) -> dict:
    """Check, repeat and time K1-K3; return the per-kernel records at the
    path's shape."""
    import numpy as np
    import torch
    from repro_torch.bench import time_ms
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import ref

    P = W_path.shape[0]
    C = 39
    rng = np.random.default_rng(1)
    W_ragged = rng.random((1000, 1000), dtype=np.float32) * (
        rng.random((1000, 1000)) < 0.02)
    records = {}
    cases = (("path", W_path, gamma, kappa, None),
             ("path κ=1e-2 g=0.5", W_path, 0.8, 1e-2, 0.5),
             ("ragged", W_ragged, gamma, kappa, None))
    for label, W_np, gc, kap, g_val in cases:
        B = W_np.shape[0]
        logp, W, g = kernel_inputs(B, C, W_np, seed=B, g=g_val)
        ge = gc
        runs = {
            "graph_reg_fwd": (
                lambda: gr.reg_forward(logp, W, gc, kap, ge),
                lambda: ref.reg_forward_ref(logp, W, gc, kap, ge)),
            "graph_reg_bwd_dlogp": (
                lambda: gr.reg_bwd_dlogp(logp, W, g, gc, kap, ge),
                lambda: ref.reg_bwd_dlogp_ref(logp, W, g, gc, kap, ge)),
            "graph_reg_bwd_dw": (
                lambda: gr.reg_bwd_dw(logp, g, gc, ge),
                lambda: ref.reg_bwd_dw_ref(logp, g, gc, ge)),
        }
        for name, (kern, plain) in runs.items():
            a, b, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{name} [{label} B={B}]: two launches "
                  "on the same inputs differ")
            rec = compare(f"{name} [{label} B={B} C={C}]", a, want)
            if label == "path":
                records[name] = dict(rec, ms=time_ms(kern),
                                     plain_ms=time_ms(plain))
        if label == "path":
            # K3 through the autograd Function with W requiring a gradient.
            Wg = W.clone().requires_grad_(True)
            lp = logp.clone().requires_grad_(True)
            from repro_torch.kernels.ops import GraphReg
            before = gr.reg_bwd_dw.launches
            GraphReg.apply(lp, Wg, gc, kap, ge).backward(g)
            check(gr.reg_bwd_dw.launches == before + 1,
                  "K3 did not launch through the autograd Function")
            compare("graph_reg_bwd_dw [path, through the autograd Function]",
                    Wg.grad, ref.reg_bwd_dw_ref(logp, g, gc, ge))
            # One PyTorch call for K3's function: addmm of P·logPᵀ onto
            # ge·H broadcast, scaled by -g (g is a known float here).
            p = torch.exp(logp[0])
            H = -(p * logp[0]).sum(-1, keepdim=True).expand(B, B)
            gv = 1.0 / B
            records["graph_reg_bwd_dw"]["library_ms"] = time_ms(
                lambda: torch.addmm(H, p, logp[0].T, beta=-gv * ge,
                                    alpha=-gv * gc))
            f4 = 4.0
            s_flops = 2.0 * B * B * C
            records["graph_reg_fwd"]["bound"] = bound_ms(
                f4 * (B * B + B * C + 1), s_flops + 2.0 * B * B + 4.0 * B * C)
            records["graph_reg_bwd_dlogp"]["bound"] = bound_ms(
                f4 * (B * B + 2 * B * C + 1), 2 * s_flops + B * B + 8.0 * B * C)
            records["graph_reg_bwd_dw"]["bound"] = bound_ms(
                f4 * (B * C + B * B + 1), s_flops + 3.0 * B * B + 2.0 * B * C)
    return records


def small_step_parity() -> None:
    """One full step with the GPU kernels against the CPU plain path."""
    import numpy as np
    import torch
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.models.dnn import DNNConfig, init_dnn
    from repro_torch.optim import adagrad
    from repro_torch.train.train_step import dnn_ssl_step

    rng = np.random.default_rng(7)
    k, P, D, C = 2, 200, 24, 39
    cfg = DNNConfig(input_dim=D, hidden_dim=64, n_hidden=2, n_classes=C,
                    dropout=0.0)
    W = rng.random((k, P, P), dtype=np.float32)
    W = (W + W.transpose(0, 2, 1)) * (rng.random((k, P, P)) < 0.05)
    valid = np.ones((k, P), bool)
    valid[:, 180:] = False
    batch = {"x": rng.standard_normal((k, P, D)).astype(np.float32),
             "y": rng.integers(0, C, (k, P)),
             "label_mask": (rng.random((k, P)) < 0.3).astype(np.float32),
             "W": W.astype(np.float32), "valid": valid}
    params0 = to_numpy(init_dnn(cfg, 3))
    hyper = SSLHyper(gamma=1.0, kappa=1e-4, weight_decay=1e-5)
    out = {}
    for dev in ("cuda", "cpu"):
        params = to_torch(params0, dev)
        opt = adagrad()
        state = opt.init(params)
        b = {key: torch.from_numpy(np.asarray(v)).to(dev)
             for key, v in batch.items()}
        params, state, metrics = dnn_ssl_step(
            params, state, b, cfg=cfg, hyper=hyper, opt=opt, lr=1e-3,
            pairwise=resolve_pairwise("auto"))
        out[dev] = ({key: float(v) for key, v in metrics.items()},
                    to_numpy(params))
    for key, v in out["cpu"][0].items():
        got = out["cuda"][0][key]
        check(abs(got - v) <= 1e-4 * max(1.0, abs(v)),
              f"small step: {key} on the GPU {got} vs CPU {v}")
    # First AdaGrad step moves each weight by ~lr·sign(g): compare in lr
    # units; a gradient entry within f32 noise of 0 may flip sign.
    worst = max(float(np.abs(a - b).max()) for a, b in zip(
        [lyr[n] for lyr in out["cuda"][1]["layers"] for n in ("w", "b")],
        [lyr[n] for lyr in out["cpu"][1]["layers"] for n in ("w", "b")]))
    check(worst <= 2.5e-3, f"small step: params differ by {worst}")
    print(f"small-step parity (k={k}, P={P}, C={C}): loss/total "
          f"gpu={out['cuda'][0]['loss/total']:.6f} "
          f"cpu={out['cpu'][0]['loss/total']:.6f}, max param diff "
          f"{worst:.2e} (lr 1e-3)")


class TimedPipeline:
    """Wraps an epoch factory: counts the batches it yields and times the
    host assembly of each.  The engine stages ``prefetch`` = d batches
    ahead, so when batch k is asked for, steps 0..k-d-1 have been launched.
    The pipeline synchronises at the request of batch d+1 (step 0 done) and
    at the request that ends the epoch (steps up to N-d-1 done): between
    the two lie steps 1..N-d-1 and the host assembly of as many batches."""

    def __init__(self, inner, prefetch: int):
        self.inner = inner
        self.d = prefetch
        self.n = 0
        self.host_s = 0.0
        self.t_steady = None
        self.t_end = None

    @property
    def steady_steps(self) -> int:
        return self.n - self.d - 1

    def __call__(self):
        import torch
        it = iter(self.inner())
        while True:
            if self.n == self.d + 1:
                torch.cuda.synchronize()
                self.t_steady = time.perf_counter()
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                torch.cuda.synchronize()
                self.t_end = time.perf_counter()
                return
            self.host_s += time.perf_counter() - t0
            self.n += 1
            yield b


def train_phase(exp) -> dict:
    import numpy as np
    from repro_torch.kernels import graph_reg as gr

    timed = TimedPipeline(exp.pipeline, exp.config.execution.prefetch)
    exp.pipeline = timed
    gr.reset_launch_counts()
    res = exp.run()
    counts = gr.launch_counts()
    check(len(res.history) == 1, "the epoch produced no history row")
    row = res.history[0]
    print("epoch row: " + json.dumps(row))
    steps = timed.n
    check(timed.steady_steps >= 2, f"too few steps ({steps}) to time")
    steady = (timed.t_end - timed.t_steady) / timed.steady_steps
    print(f"main path: {steps} steps, {1e3 * steady:.3f} ms/step over steps "
          f"1..{timed.steady_steps} (host clock, prefetch {timed.d}), host "
          f"batch assembly {1e3 * timed.host_s / steps:.3f} ms/step, "
          f"launches {counts}")
    check(np.isfinite(row["loss/total"]) and np.isfinite(row["eval/acc"]),
          "non-finite loss/total or eval/acc")
    check(counts["graph_reg_fwd"] == steps, "K1 did not launch every step")
    check(counts["graph_reg_bwd_dlogp"] == steps,
          "K2 did not launch every step")
    check(counts["graph_reg_bwd_dw"] == 0,
          "K3 launched though W needs no gradient")
    return {"counts": counts, "steps": steps, "steady_ms": 1e3 * steady,
            "host_ms": 1e3 * timed.host_s / steps}


def w_grad_path(W_path, gamma: float, kappa: float) -> dict:
    """The regularizer's VJP with respect to W (what graph-weight learning
    asks for), through the ``"auto"`` registry entry a user calls, at the
    main path's shape.  Counts at 0 just before, read just after: K3's only
    path, since training never needs dW."""
    import torch
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.kernels import graph_reg as gr

    logp, W, _ = kernel_inputs(W_path.shape[0], 39, W_path, seed=3)
    logp.requires_grad_(True)
    W.requires_grad_(True)
    gr.reset_launch_counts()
    resolve_pairwise("auto")(logp, W, gamma, kappa).sum().backward()
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    print(f"W-gradient path: launches {counts}")
    check(counts == {"graph_reg_fwd": 1, "graph_reg_bwd_dlogp": 1,
                     "graph_reg_bwd_dw": 1},
          "the W-gradient path did not run K1, K2 and K3 once each")
    check(bool(torch.isfinite(W.grad).all() and torch.isfinite(logp.grad).all()),
          "non-finite gradients on the W-gradient path")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"FAIL: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from repro_torch.api import Experiment
    from repro_torch.bench import paper_config, profile_step
    from repro_torch.device import resolve_device
    resolve_device("cuda")   # pins TF32 off for every product below

    build_all()
    t0 = time.time()
    exp = Experiment(paper_config(), device="cuda").build()
    P = exp.pipeline.__self__.pad
    print(f"host pipeline: n={exp.corpus.X.shape[0]} nodes, "
          f"{exp.plan.n_meta} meta-batches, padded batch P={P}, "
          f"{time.time() - t0:.1f}s")
    obj = exp.config.objective
    W_path = real_block(exp, P)
    records = kernel_phase(W_path, obj.gamma, obj.kappa)
    small_step_parity()
    train = train_phase(exp)
    w_grad = w_grad_path(W_path, obj.gamma, obj.kappa)
    exp.pipeline = exp.pipeline.inner
    step = profile_step(exp, trace=False)
    print(f"step breakdown: step between CUDA events, back to back "
          f"(includes host launch gaps) {step['step_ms_events']:.3f} ms, "
          f"host batch assembly "
          f"{step['host_batch_assembly_ms']:.3f} ms, staging (pinned copy + "
          f"H2D) {step['host_staging_ms']:.3f} ms")

    from repro_torch.kernels.graph_reg import SOURCE
    kernels = []
    for name, rec in records.items():
        b_ms, b_by = rec["bound"]
        # K1/K2 count on the training path; K3 on the W-gradient path (the
        # training path launches it 0 times, checked above).
        path, counts = (("w_grad", w_grad) if name == "graph_reg_bwd_dw"
                        else ("train", train["counts"]))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "path": path,
            "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
            "rtol": RTOL, "err_over_tol": rec["err_over_tol"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": rec.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
