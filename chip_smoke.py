#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--against DIR]

``--against DIR`` also builds the C entry points of K1-K11 from another
checkout's sources (DIR, e.g. the parent commit unpacked with ``git
archive``) and times them in turns with this checkout's on the same
inputs, outputs equal bit for bit (phase 5); K1, K2, K10, K4, K6 and K7
are also compared bit for bit at ragged, multi-chunk shapes.  Every
kernel time below is the device time of one call from a CUDA graph of
back-to-back calls (``bench.graph_ms``), the kernel,
its plain version and the library call (where there is one) two rounds
in turns; the wrappers are given p = exp(logp), as the training path
gives it.

Phases, each fatal on failure (nothing is caught and swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``src/repro_torch/csrc`` from this
   checkout, one ``nvcc`` per source, all started together; K11's
   tensor-core kernels and the redesigned K3 and K5 must report no
   spills, nor may the redesigned K1, K2, K4, K6, K7 and K10 (``-Xptxas
   -v``, registers and shared memory printed; K3 and K7, one tile body,
   with the blocks an SM their registers and shared memory allow, at
   least three for K7), and the library must hold ``HGMMA`` (tensor-core)
   instructions;
3. host pipeline of the paper's configuration: corpus, k-NN graph,
   partition and meta-batch plan (``Experiment.build``), which fixes the
   padded batch size P of the main path; then the device graph build:
   ``Experiment.build`` with ``construction="device"`` on the same corpus
   (n = 20,000, D = 351, k = 10), counts at 0 just before and read just
   after (K8 exactly once, nothing else), less than N²·4/10 bytes of
   device memory over the call (no N×N buffer), its seconds split into
   H2D, K8 and the host's sigma/CSR beside the host search's, and its
   graph held against the host graph (sigma within rel 1e-5, edge churn
   ≤ 1e-3, every differing edge at a near-tie row), and the two graphs'
   weights compared on their common edges (max |Δw| and relative Δw);
4. kernels: K1, K2 and K3 at the path's shape (k=1, B=P, C=39, γ=1,
   κ=1e-4, g=1/B, W a real padded affinity block), at the same shape with
   γ=0.8, κ=1e-2 and g=0.5 (so the κ and degree terms are not lost under
   the tolerance), and at a ragged shape (B=1000), each held against its
   plain PyTorch version on the card, run twice for bit-identical repeats,
   and timed beside its plain version; K3 also beside one PyTorch call
   computing the same function (``addmm``);
5. block-sparse kernels K4–K7 the same way, on the path's block and the
   layout ``block_layout(W, 128)`` gives it (with both scalar sets), on a
   ragged B=1000, bt=64 random symmetric tile mask, on a mask with an
   empty tile row, and on a full mask, where K4 must equal K1, K5∘K6 K2
   and K7 K3 bit for bit; K5 is timed beside ``torch.bmm(W.mT, p)`` and
   K6 beside ``torch.bmm(W, logp)`` (their dense products alone) as K3
   beside ``addmm``, and K7 beside ``zero_`` of its dense output (its
   floor, not a library call for its function); the redesigned K3 and K5
   also at k = 2, ragged B
   (1000, 1001), C in {1, 39, 100} and, for K5, bt in {32, 64, 128} and
   a full mask at bt = 32, C = 128 (a 36,864-tile list); with
   ``--against`` K1-K7, K10 and K11 (at the serve prefill's bf16 shape)
   built from DIR, which must give
   the same bits (K1, K2 and K10 also at k = 3, B = 1001, C = 100 and at
   B = 1001, C = 200, K4 and K6 at six ragged shapes and tile edges; K8
   at k = 10, 40, 300 on 4,000 rows and 1,000 on
   2,000 rows, K9 on the path's rows and at 1000 × 333, each timed in
   turns but k = 40, the ragged K9 and the ragged K4 and K6; and the two
   kernels whose redesign changes their bits, K1 at the LM head (1, 16,
   151936) on the class-split plan and K11 at kimi's bf16 shape on the
   tensor-core route, timed in turns with DIR's, each build held to its
   own rule, whether they differ printed, K11 at least 8× faster than a
   DIR that still runs the FMA kernel at hd 112; K2 on its class route at
   every LM head equal to DIR's bit for bit, timed in turns at (1, 16,
   151936) and at least 5× faster than a DIR on the row route; after
   the dense epoch, a fresh dense epoch on this build's K1/K2 and one on
   DIR's, both equal to the main path's row bit for bit); the
   redesigned K1 and K2 also at k in {1, 3}, B in
   {1, 31, 33, 1000, 1001}, C in {1, 39, 100, 128, 200}, K4 and K6 at the
   same shapes with bt in {32, 64, 128, 256} on four kinds of tile mask
   (an empty tile row, one tile row holding every tile, tail-padded
   lists, a full mask), K7 (on K3's tile) at k 1/3, B 1/33/130/1000/1001,
   C 1/39/200 and bt 32/64/96/128/160/256 on the same masks (zero off the
   occupied tiles, K3's bits on a full mask), and K10 == K1 at
   (1, 0, 0) at B = 1001; K8 (streaming top-k) on the whole corpus at
   k = 10 (the path's)
   and k = 40 (shared-memory route), and at k = 300 on 4,000 rows and k =
   1,000 on 2,000 rows (global route, timed), against the dense plain
   version (|Δd2| ≤ 1e-5·(‖x_i‖² + ‖y_j‖²), indices equal except at near
   ties), K9 (RBF block) on the path's meta-batch rows with the graph's
   sigma (128-row tiles), a ragged 1000 × 333 block and the first 2176
   corpus rows (64-row tiles, timed), K10 (bare cross term) on the path's
   block and a ragged one; each
   repeated bit for bit and timed beside its plain version and, for K8
   and K9, a PyTorch call (``mm`` and ``cdist``, which compute only the
   products or distances); K9 and K10 then once through their ``ops``
   entries with the counts at 0 just before and read just after;
6. small-step parity: one ``dnn_ssl_step`` with the GPU kernels against the
   same step on the CPU (plain versions), from the same params and batch,
   without and with a block layout on the batch;
7. main path: ``repro_torch.api.Experiment(cfg, device="cuda").run()`` at
   the paper's width (4×2000 DNN, 351→39, batch 1024) for one epoch, with
   every kernel launch counter set to 0 just before and read just after,
   and the steady ms/step timed between two synchronised points;
   K1 and K2 must launch once per step and no other kernel; then the
   W-gradient path (the ``"auto"`` entry's VJP with ``W`` requiring a
   gradient, at the same shape), which must launch K1, K2 and K3 once;
8. the block-sparse main path: the same epoch with
   ``BatchConfig(layout_bt=128)`` on the same corpus, graph and plan; K4,
   K5 and K6 must launch once per step and no other kernel, and its
   ``loss/total`` must equal the dense epoch's bit for bit; then its
   W-gradient path, which must launch K4, K5, K6 and K7 once;
9. one epoch on the device-built graph: K1 and K2 once per step, K8 and
   every other kernel 0 times, its loss/total printed beside the one
   measured before K8's redesign; then one on the host graph's edges and
   plan with the device graph's weights, whose loss/total is compared
   with the device epoch's (a measurement: the weights' round-off alone,
   or not);
10. the engine extras at the paper's width, each through ``Experiment``:
   checkpoint and resume (2 epochs, ``checkpoint_every=1``; stopped after
   epoch 1 and resumed, and resumed past a LATEST target truncated by the
   injector's checkpoint fault; the final checkpoint's arrays and the
   history equal the uninterrupted run's bit for bit); the non-finite
   guard (a NaN batch and an inf batch in one epoch: exactly 2 steps
   skipped, params finite, launches the epoch's plus the replayed
   windows' of ``guard_window`` chunks of ``scan_chunk`` steps; without
   the guard the params end non-finite); the online
   graph refresh (the stream pipeline, its graph built on K8 and
   refreshed on K8 after each of 2 epochs from the top hidden layer, N
   20,000 × D 2000: K8 once for the build and once per refresh, churn and
   repair or re-plan printed, the refreshed graph against the host graph
   of the same embeddings, K8 checked and timed at that shape); then the
   execution strategies at k = 4 (``strategies_phase``): a sequential and
   a ``sync_mesh`` epoch on a world-size-1 NCCL group, equal bit for bit
   (loss/total, history, params), the NCCL version printed; an
   ``async_ps`` epoch on 1-worker batches, repeated bit for bit, and its
   checkpoint (params, AdaGrad state, 4 snapshots) resumed bit for bit;
   each epoch K1 and K2 once per step and no other kernel, ms/step by
   the host clock; the chaos driver's three phases on the card
   (``chaos_phase``: every site fired, skips as planned, phase C = phase
   A bit for bit, phase A's fired coordinates the plan's); and the
   guard's cost on a clean epoch (``guard_overhead_phase``: off and on in
   five interleaved pairs at ``scan_chunk`` 1 and 16, the median per-pair
   ratio printed, not checked);
11. a step breakdown of both paths (``repro_torch.bench.profile_step``
   without the profiler): host batch assembly, staging, and one full step
   timed between CUDA events, back to back (which includes the host's
   launch gaps); then the quickstart (``quickstart_phase``, the twin of
   ``examples/quickstart.py`` at its defaults: n 4000, label ratio 0.02,
   10 epochs): the SSL run and the supervised run (γ = κ = 0) on the
   card, each with K1 and K2 once a step and nothing else, every loss
   finite, held per epoch to the same runs on the CPU from the same
   initial params by the rule of :data:`QS_FIRST_RTOL` to :data:`QS_ACC`,
   which two planted faults on the card (:data:`QS_PLANTED`) must break;
   accuracies by epoch, the SSL − supervised gap, seconds and ms/step;
12. the LM serve path (``python -m repro_torch.serve.serve_lm``): K11 at
   the prefill's shape, q (4, 2048, 12, 128) against k, v (4, 2048, 2,
   128), in bf16 (tensor-core route) and f32 (FMA route), and at a ragged
   T = 1000 and a Tq < Tk case, at llama/jamba's and at the four head
   layouts of :data:`LAYOUT_ATTN` (groups 1, 3 and 8 at hd 64 and 128),
   each labelled with its route and held
   against its plain version on the route's key tiles, repeated bit for
   bit and timed beside it and, in turns, beside
   ``scaled_dot_product_attention`` (the library column only), with the
   path case's TFLOP/s and share of its bound; then ``qwen2-1.5b`` at
   full width, 2 layers, f32, on the card against the CPU (prefill logits
   and cache, 4 greedy decode steps); then the full model (28 layers,
   bf16, weights from a seed on the card), batch 4, prompt 2048, 32
   greedy decode steps, cache 2080, through ``serve_lm``'s functions:
   counts at 0 just before the prefill (K11 exactly 28 times, K14 57,
   nothing else) and again before the decode (no kernel at all), logits
   finite,
   prefill ms, decode ms/token, tok/s and peak device memory;
13. the LM training path with the paper's sequence-level objective
   (``lm_kernel_phase`` to ``lm_train_phase``): K1 and K2 at the LM
   head's shapes (:data:`LM_HEAD_SHAPES`: (k, B, C) = (1, 16, 151936), (2,
   16, 151936), (1, 17, 32000), the SSL heads, the smoke's (1, 4,
   512) and every other configuration's V, 200064, 64000, 2048, 163840,
   128256 and 65536) with the example's γ = 0.05, κ = 1e-4, held against their
   plain versions (K1 to float64, :data:`K1_LM_RULE`), repeated bit for
   bit and timed beside them with their share of the bound; K1's plan
   printed at each (the class-split plan: pass-1 blocks, class chunk,
   the library's equal to the Python mirror's), and K2's (the class
   route: class span, blocks, threads, no workspace, the library's equal
   to the mirror's), each kernel's passes profiled, K1 and K2 no slower
   than their plain versions at any; ``qwen2-1.5b`` at full width, 2 layers, f32: one
   ``lm_loss`` forward and backward on the card against the CPU (the
   example's first batch, 8 sequences of 64 tokens, W from the host
   graph; metrics within rtol 1e-4, each gradient leaf within 1e-3 of its
   largest |value|); then the full model (28 layers, bf16, weights from a
   seed on the card) through ``lm_train_step`` with AdaGrad on the
   example's pipeline (512 sequences, bag-of-tokens k-NN graph, k = 10,
   meta-batches of 8 with a sampled neighbour): 16 sequences of 4,096
   tokens a step, 6 steps with the counts at 0 just before and read just
   after (K1 and K2 exactly once a step, nothing else), every loss
   finite, ms/step over steps 2-6, tokens/s and peak device memory; 2
   steps of ``lm_supervised_step`` (no kernel); one more step timed
   apart (forward and backward, update);
14. sliding windows (``swa_parity_phase``, ``swa_serve_phase``): a
   2-layer full-width f32 cut with every layer ATTN_SWA at window 256,
   prompt 640, on the card against the CPU (prefill logits, ring caches,
   4 greedy decode steps); then ``config_for_shape(qwen2-1.5b,
   long_500k)`` at full depth in bf16 (window 8,192), batch 1, prompt
   10,240, 16 greedy decode steps through ``serve_lm``'s functions, no
   kernel launched, prefill ms, ms/token and peak memory;
15. the rest of the LM stack (``flash_attention_hd112_phase`` to
   ``family_train_phase``): K11 at kimi-k2's head dim 112, q (4, 2048,
   64, 112) against k, v (4, 2048, 8, 112) in bf16 (tensor-core route,
   128-key tiles) and a ragged f32 case (FMA route, 64-key tiles), held to
   its plain version on its route's tiles, repeated bit for bit, timed in
   turns beside it and SDPA, with its bound, its share of it and its
   factor over SDPA; K12 and K13 (``moe_kernel_phase``) in bf16 at the
   mixtral prefill cell's request (8,192 tokens of 4,096, 8 experts, top
   2), at a skewed load and at a decode step's batch of 4, bit for bit
   against their plain versions on the same card tensors and against a
   second launch, timed in turns with them, with their bounds by bytes
   and their share of them; K14 (``norm_kernel_phase``) against its
   plain version, the float32 composite, on the same card tensors under
   ``kernels.norm.RULE`` at the four prefill cells' norms (bf16: 8,192
   rows of 1,536, 3,072 and 4,096, 32,768 of 1,536) and at every config's
   width on 64 rows in bf16 and float32, repeated bit for bit, its launch
   plan the library's, the cells' shapes timed in turns with the
   composite and ``torch.nn.functional.rms_norm`` over inputs cycled past
   the L2, with its bound by bytes; the ``reduced()`` configs of
   mixtral-8x7b, kimi-k2-1t-a32b, llama-3.2-vision-90b,
   jamba-1.5-large-398b, xlstm-125m, qwen1.5-0.5b, musicgen-large,
   phi4-mini-3.8b and yi-9b in f32 on the card against the CPU
   (prefill logits, every cache or state leaf and 4 greedy decode steps
   within atol 1e-4, MoE experts and the prefill's rows an expert or the
   decode's keep masks equal, two card runs
   equal bit for bit); each family served at full width with depth cut
   to one card (:data:`FAMILY_CUTS`, printed on its line; qwen1.5-0.5b,
   musicgen-large, phi4-mini-3.8b, yi-9b and xlstm-125m whole): batch 4,
   prompt 2048, 32 greedy decode steps, cache 2080, the VLM with seeded
   (4, 1601, 1280) modality embeddings, K11 launches counted from 0 just
   before the timed prefill (2 kimi, 4 llama, 1 jamba, 4 mixtral, 0
   xLSTM, 24 qwen1.5, 48 musicgen, 32 phi4, 48 yi; K12 and K13 once a MoE
   layer; K14 at every RMSNorm, ``prefill_norms``, and never in the
   decode), logits finite, prefill ms, ms/token, tok/s, peak memory and
   the MoE assignments dropped (none: serving is dropless); then two
   ``lm_train_step``s
   of each of :data:`FAMILY_TRAIN` (mixtral, musicgen, phi4 and yi at full
   width, 2 layers; xlstm-125m and qwen1.5-0.5b whole) at the
   example's 16 × 128 tokens: loss terms finite, ``moe_aux`` > 0, K1 and
   K2 once a step, ms/step and peak memory;
16. the launcher (``launch_phase``): ``python -m
   repro_torch.launch.train --smoke`` for every architecture of
   ``repro_torch.configs`` in one process on the card (the reduced
   config, B 4 × T 32, 10 steps through the engine in chunks of 5,
   AdaGrad, the SSL head on K1 and K2): losses finite, K1 and K2 exactly
   once a step and nothing else (counts at 0 just before each engine run,
   read just after), each step's loss within :data:`SMOKE_RTOL` of the
   same run on the CPU from the same initial params, ms/step (K1 and K2
   are held at the smoke's SSL head, (1, 4, 512), by ``lm_kernel_phase``:
   the loss rule cannot see a wrong K2); then the
   dry run on the ``meta`` device (``repro_torch.launch.dryrun``, full
   width and depth, nothing allocated) of every architecture at train_4k
   on the single-pod mesh under fsdp_tp and of qwen2-1.5b at every input
   shape on both meshes under every strategy: every record ``ok``, its
   trace seconds, dominant roofline term and per-chip argument bytes
   printed;
17. the analysis tooling on the card (``analysis_phase``): all seven
   audit passes (``repro_torch.analysis.build_report(device="cuda")``)
   with no finding outside the port's baseline, the kernels each audited
   entry launched inside its kernel boundary (K1-K3 once in the fused
   entry, K4-K7 once in the block-sparse one, K8 once in the k-NN
   entries, K1 and K2 once a step in every engine entry), each engine
   chunk traced again under ``torch.cuda.set_sync_debug_mode("error")``
   and each entry run twice on seeded random inputs under
   ``torch.use_deterministic_algorithms(True)`` (held to J004 and D001),
   every launch model held to the library's plan, the compiler's report
   (static shared memory, no spill) and the runtime's occupancy
   (resident blocks at least the launch bounds' minimum), and planted
   twins: a model 1 byte over the budget, a sync inside a chunk, and a
   float ``index_add_`` that D001 flags and that differs between two
   runs without deterministic algorithms;
18. the ``{"kernels": [...]}`` line (K1's and K2's entries with their LM
   head records under ``lm_train``, their smoke launches under
   ``launch_smoke`` and the quickstart's under ``quickstart``, K11's at
   the four head layouts under ``head_layouts``, K11 at hd 112 as
   ``flash_attention_hd112``, K12's and K13's at the mixtral prefill
   cell's request with the launches of the served mixtral prefill and
   their other cases under ``cases``, K14's at qwen2-1.5b's prefill norm
   (8,192 rows of 1,536, bf16) with the launches of the served qwen2
   prefill, the families' under ``family_launches`` and its other shapes
   under ``cases``, each
   entry with what the analysis phase read of its launch at the path's
   shape under ``launch_model``: registers, spills and static shared
   memory from the compiler, resident blocks from the runtime, dynamic
   shared memory from the library's plan query), then the result line.

Exits non-zero without a GPU or without the package beside this script.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: HBM bandwidth, the f32 rate outside the tensor cores
# and the dense bf16 tensor-core rate (the least time for the work on these
# inputs' type, whatever the kernel uses).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

REPLACES = {
    "graph_reg_fwd": "src/repro/kernels/graph_reg.py:145 _fused_reg_forward "
                     "(kernel _fused_reg_kernel :99)",
    "graph_reg_bwd_dlogp": "src/repro/kernels/graph_reg.py:329 _reg_bwd_dlogp "
                           "(kernel _reg_bwd_dlogp_kernel :262)",
    "graph_reg_bwd_dw": "src/repro/kernels/graph_reg.py:371 _reg_bwd_dw "
                        "(kernel _reg_bwd_dw_kernel :299)",
    "graph_reg_bsp_fwd": "src/repro/kernels/graph_reg.py:520 _bsp_forward "
                         "(kernel _bsp_fwd_kernel :465, call :555)",
    "graph_reg_bsp_bterm": "src/repro/kernels/graph_reg.py:684 _bsp_bwd pass "
                           "1 (kernel _bsp_bterm_kernel :589, call :702)",
    "graph_reg_bsp_dlogp": "src/repro/kernels/graph_reg.py:684 _bsp_bwd pass "
                           "2 (kernel _bsp_dlogp_kernel :615, call :722)",
    "graph_reg_bsp_dw": "src/repro/kernels/graph_reg.py:684 _bsp_bwd pass 3 "
                        "(kernel _bsp_dw_kernel :648, call :753)",
    "knn_topk": "src/repro/kernels/pairwise.py:161 _knn_topk (kernel "
                "_topk_kernel :104, call :170; entry knn_topk_pallas :199)",
    "rbf_affinity": "src/repro/kernels/pairwise.py:66 rbf_affinity_pallas "
                    "(kernel _pairwise_kernel :45, call :83)",
    "graph_reg_pairwise": "src/repro/kernels/graph_reg.py:214 "
                          "graph_reg_pairwise_pallas (kernel "
                          "_graph_reg_kernel :73, call :241)",
    "flash_attention": "src/repro/kernels/flash_attention.py:69 "
                       "flash_attention_fwd_pallas (kernel _flash_fwd_kernel "
                       ":29, call :95; GQA wrapper flash_attention_gqa_pallas "
                       ":117)",
}
#: K8 and K9 against their plain versions: |Δd2| ≤ D2_RTOL·(‖x_i‖² +
#: ‖y_j‖²).  d2 = ‖x‖² − 2·x·y + ‖y‖² in float32 loses up to ~1.2e-6 of
#: that scale to round-off (measured against float64 on the corpus), and
#: the kernel and cuBLAS sum the products in different orders.
D2_RTOL = 1e-5
#: Tile edge of the block-sparse main path.
LAYOUT_BT = 128


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
TOL_RULE = f"|Δ| ≤ tol + {RTOL:g}·|want|, tol = {RTOL:g}·max|want|"


def compare(name: str, got, want, quiet: bool = False) -> dict:
    """Hold ``got`` to ``want`` under :data:`TOL_RULE`; print the errors
    unless ``quiet`` (a failure is always fatal and named)."""
    import torch
    err = (got - want).abs()
    atol = RTOL * float(want.abs().max())
    limit = (atol + RTOL * want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    over = float((err / limit).max())
    rec = {"max_abs_err": float(err.max()), "tol": atol, "err_over_tol": over}
    if not quiet:
        print(f"{name}: max_abs_err={rec['max_abs_err']:.3e} atol={atol:.3e} "
              f"rtol={RTOL:g} err/tol={over:.3f}")
    check(math.isfinite(over) and over <= 1.0,
          f"{name} disagrees with its plain version (err/tol {over:.3f})")
    return rec


def bound_ms(bytes_moved: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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


def block_rows(exp, P: int):
    """The corpus rows of the path's block: two meta-batches of the plan,
    concatenated, at most P."""
    import numpy as np
    plan = exp.plan
    return np.concatenate([plan.meta_batches[0], plan.meta_batches[1]])[:P]


def real_block(exp, P: int):
    """A padded affinity block as the main path builds it: the rows of
    :func:`block_rows`, zero-padded to P."""
    import numpy as np
    idx = block_rows(exp, P)
    W = np.zeros((P, P), np.float32)
    W[:len(idx), :len(idx)] = exp.graph.dense_block(idx)
    return W


def sync_time(fn):
    """(result, seconds) of ``fn()`` between two device synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def near_tie_rows(X, k: int):
    """Rows whose exact (float64) k-th and (k+1)-th squared distances lie
    within D2_RTOL·(‖x_i‖² + max_j ‖x_j‖²) of each other: where float32
    round-off may pick another k-th neighbour.  float64 on the card, 4096
    rows at a time."""
    import torch
    x = torch.from_numpy(X).to("cuda", torch.float64)
    sq = (x * x).sum(1)
    near = torch.empty(len(X), dtype=torch.bool, device="cuda")
    for s in range(0, len(X), 4096):
        e = min(s + 4096, len(X))
        d2 = sq[s:e, None] - 2.0 * (x[s:e] @ x.T) + sq[None, :]
        d2[torch.arange(e - s), torch.arange(s, e)] = torch.inf
        top = torch.topk(d2, k + 1, dim=1, largest=False).values
        near[s:e] = (top[:, k] - top[:, k - 1]) <= D2_RTOL * (sq[s:e] + sq.max())
    return near.cpu().numpy()


def graph_build_phase(exp) -> dict:
    """``Experiment.build`` with ``construction="device"`` on the host
    experiment's corpus: K8 once, no N×N buffer, its time split, and its
    graph against the host graph."""
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.bench import paper_config
    from repro_torch.core.affinity import build_affinity_graph
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import pairwise
    from repro_torch.online.refresh import edge_churn, edge_set

    X = np.ascontiguousarray(exp.corpus.X, np.float32)
    n, k = len(X), exp.config.graph.k
    t0 = time.perf_counter()
    build_affinity_graph(X, k=k, backend="host")
    host_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gr.reset_launch_counts()
    exp_dev, build_s = sync_time(lambda: Experiment(
        paper_config(construction="device"), corpus=exp.corpus,
        eval_data=exp.eval_data, device="cuda").build())
    counts = gr.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"device graph build: Experiment.build {build_s:.3f}s, launches "
          f"{counts}, peak device memory over the call {peak / 1e6:.1f} MB "
          f"(limit N²·4/10 = {n * n * 0.4 / 1e6:.1f} MB)")
    check(counts == {name: int(name == "knn_topk") for name in counts},
          f"the device graph build launched {counts}, not K8 exactly once")
    check(peak < n * n * 4 / 10, f"the device graph build allocated {peak} "
          f"bytes over the K8 call: an N×N buffer?")

    # Where the graph stage's time goes: H2D, K8, D2H, then the host's
    # sigma, RBF weights and CSR symmetrisation (by difference).
    x, h2d_s = sync_time(lambda: torch.from_numpy(X).cuda())
    (d2, idx), k8_s = sync_time(
        lambda: pairwise.knn_topk(x, x, k, exclude_self=True))
    _, d2h_s = sync_time(lambda: (idx.cpu().numpy(), d2.cpu().numpy()))
    _, graph_s = sync_time(lambda: build_affinity_graph(
        X, k=k, backend="device", device="cuda"))
    rest_s = graph_s - h2d_s - k8_s - d2h_s
    print(f"graph stage: host k-NN graph (backend host) {host_s:.3f}s; "
          f"device k-NN graph {graph_s:.3f}s = H2D {h2d_s:.4f}s + K8 "
          f"{k8_s:.4f}s + D2H {d2h_s:.4f}s + host sigma/RBF/CSR "
          f"{rest_s:.3f}s (by difference)")

    g_host, g_dev = exp.graph, exp_dev.graph
    rel = abs(g_dev.sigma - g_host.sigma) / g_host.sigma
    a, b = edge_set(g_host), edge_set(g_dev)
    diff = a ^ b
    churn = edge_churn(g_host, g_dev)
    near = near_tie_rows(X, k)
    bad = [e for e in diff if not (near[e[0]] or near[e[1]])]
    touched = sorted({i for e in diff for i in e})
    print(f"device vs host graph: sigma {g_dev.sigma!r} vs {g_host.sigma!r} "
          f"(rel {rel:.2e}), {len(a)} vs {len(b)} edges, symmetric "
          f"difference {len(diff)} of {len(a | b)} (churn {churn:.2e}), "
          f"{len(touched)} rows touched, {int(near.sum())} near-tie rows in "
          f"the corpus, {len(bad)} differing edges at no near-tie row")
    same = g_host.W.indices.size == g_dev.W.indices.size and bool(
        (g_host.W.indices == g_dev.W.indices).all()
        and (g_host.W.indptr == g_dev.W.indptr).all())
    dw = (float(np.abs(g_host.W.data - g_dev.W.data).max()) if same
          else float("nan"))
    plan_same = len(exp.plan.meta_batches) == len(
        exp_dev.plan.meta_batches) and all(
        np.array_equal(a, b) for a, b in zip(exp.plan.meta_batches,
                                             exp_dev.plan.meta_batches))
    print(f"device vs host graph: same edge structure {same}, max |ΔW| on "
          f"it {dw:.3e}; same meta-batch plan {plan_same}; padded batch P "
          f"{exp_dev.pipeline.__self__.pad} (host {exp.pipeline.__self__.pad})")
    # The weights on the edges both graphs hold.
    ch, cd = g_host.W.tocoo(), g_dev.W.tocoo()
    _, ih, idv = np.intersect1d(ch.row.astype(np.int64) * n + ch.col,
                                cd.row.astype(np.int64) * n + cd.col,
                                return_indices=True)
    wh, wd = ch.data[ih].astype(np.float64), cd.data[idv].astype(np.float64)
    dabs = np.abs(wd - wh)
    print(f"device vs host graph weights on {len(ih)} common edges: max "
          f"|Δw| {dabs.max():.3e}, max relative Δw "
          f"{(dabs / np.maximum(np.abs(wh), 1e-300)).max():.3e}, mean |Δw| {dabs.mean():.3e} "
          f"(host weights {wh.min():.3e}..{wh.max():.3e})")
    check(rel <= 1e-5, f"device sigma differs from host sigma by rel {rel}")
    check(churn <= 1e-3, f"device graph churn {churn} against the host graph")
    check(not bad, f"differing edges away from near ties: {bad[:10]}")
    return {"exp": exp_dev, "counts": counts, "build_s": build_s,
            "host_s": host_s, "graph_s": graph_s, "k8_s": k8_s}


def knn_kernel_phase(X, k: int, with_times: bool = True) -> dict:
    """K8 on the whole corpus against the dense plain version; timed
    beside it unless ``with_times`` is False."""
    import numpy as np
    import torch
    from repro_torch.bench import graph_ms
    from repro_torch.kernels import pairwise, ref

    x = torch.from_numpy(np.ascontiguousarray(X, np.float32)).cuda()
    N, D = x.shape

    def kern():
        return pairwise.knn_topk(x, x, k, exclude_self=True)

    def plain():
        return ref.knn_topk_ref(x, x, k, exclude_self=True)

    (d2, idx), (d2b, idxb), (pd, pi) = kern(), kern(), plain()
    torch.cuda.synchronize()
    check(torch.equal(d2, d2b) and torch.equal(idx, idxb),
          "knn_topk: two launches on the same inputs differ")
    rows = torch.arange(N, device="cuda")[:, None]
    check(bool(((idx >= 0) & (idx < N) & (idx != rows)).all()),
          "knn_topk: an index out of range or the row itself")
    check(bool((idx.sort(1).values.diff(dim=1) != 0).all()),
          "knn_topk: a repeated neighbour in a row")
    check(bool((d2.diff(dim=1) >= 0).all()), "knn_topk: a row out of order")
    nx = (x * x).sum(1)
    scale = nx[:, None] + torch.maximum(nx[idx.long()], nx[pi.long()])
    err = (d2 - pd).abs()
    over = float((err / (D2_RTOL * scale)).max())
    # An index may differ only where the two candidates' plain d2 are
    # within the same tolerance of each other (a near tie).
    mis_r, mis_c = (idx != pi).nonzero(as_tuple=True)
    if len(mis_r):
        alt = torch.gather(ref._sq_dists(x[mis_r], x), 1,
                           idx[mis_r, mis_c].long()[:, None])[:, 0]
        tie = (alt - pd[mis_r, mis_c]).abs() <= D2_RTOL * scale[mis_r, mis_c]
        check(bool(tie.all()), "knn_topk: an index differs away from a tie")
    print(f"knn_topk [N=M={N} D={D} k={k}, {pairwise.route(k)} route]: "
          f"max_abs_err={float(err.max()):.3e} "
          f"err/tol={over:.3f} (tol {D2_RTOL:g}·(‖x_i‖²+‖y_j‖²)), "
          f"{len(mis_r)} indices differ from the plain version, all at near "
          f"ties, in {len(set(mis_r.tolist()))} rows")
    check(math.isfinite(over) and over <= 1.0,
          "knn_topk disagrees with its plain version")
    if not with_times:
        return {}
    times = timed(kern, plain)
    mm_ms = graph_ms(lambda: torch.mm(x, x.T))
    plan = pairwise.launch_plan("knn_topk", N, N, D, k, same=True)
    print(f"knn_topk: {times['ms']:.3f} ms; plain (dense matrix + stable "
          f"sort) {times['plain_ms']:.3f} ms; no PyTorch call computes the "
          f"top-k without the N×N matrix: torch.mm(x, x.T) alone takes "
          f"{mm_ms:.3f} ms ({times['ms'] / mm_ms:.3f}×); plan {plan}")
    return {"route": pairwise.route(k), **plan, "mm_ms": mm_ms,
            "max_abs_err": float(err.max()),
            "tol": D2_RTOL,
            "tol_rule": f"|Δd2| ≤ tol·(‖x_i‖²+‖y_j‖²); indices equal but "
                        f"at near ties ({len(mis_r)} here)",
            "err_over_tol": over, **times,
            "note": f"no PyTorch call computes it without the N×N matrix; "
                    f"torch.mm(x, x.T) alone {mm_ms} ms",
            "bound": bound_ms(4.0 * (N * D + N + 2 * N * k),
                              2.0 * N * N * D + 3.0 * N * N)}


def rbf_kernel_phase(X, sigma: float, corpus) -> dict:
    """K9 on the path's meta-batch rows X (x = y) with the graph's sigma,
    on a ragged block, and on the first P = 2176 corpus rows, where its
    plan takes 64-row tiles (the path's block takes 128), timed too."""
    import numpy as np
    import torch
    from repro_torch.kernels import pairwise, ref

    x = torch.from_numpy(np.ascontiguousarray(X, np.float32)).cuda()
    xp = torch.from_numpy(np.ascontiguousarray(corpus[:2176],
                                               np.float32)).cuda()
    n, D = x.shape
    records = {}
    cases = (("path", x, x), ("ragged", x[:1000], x[:333].contiguous()),
             ("P×P", xp, xp))
    for label, a_in, b_in in cases:
        def kern():
            return pairwise.rbf_affinity(a_in, b_in, sigma)

        def plain():
            return ref.rbf_affinity_ref(a_in, b_in, sigma)

        a, b, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        where = f"rbf_affinity [{label} {tuple(a.shape)} D={D} σ={sigma:.4f}]"
        check(torch.equal(a, b), f"{where}: two launches differ")
        # |Δ√d2| ≤ √|Δd2|: the square root amplifies d2's round-off near
        # d2 = 0 (the diagonal).
        sq_a, sq_b = (a_in * a_in).sum(1), (b_in * b_in).sum(1)
        tol = 2e-5 + want * torch.sqrt(
            D2_RTOL * (sq_a[:, None] + sq_b[None, :])) / (2 * sigma * sigma)
        err = (a - want).abs()
        over = float((err / tol).max())
        print(f"{where}: max_abs_err={float(err.max()):.3e} err/tol="
              f"{over:.3f}")
        check(math.isfinite(over) and over <= 1.0,
              f"{where} disagrees with its plain version")
        if label == "path":
            plan = pairwise.launch_plan("rbf_affinity", n, n, D, same=True)
            records = {"max_abs_err": float(err.max()), "tol": 2e-5,
                       "library": "torch.cdist",
                       "rows_per_block": plan["rows_per_block"],
                       "dynamic_smem_bytes": 4 * pairwise.D2_STAGES
                       * pairwise.D2_K * (plan["rows_per_block"]
                                          + pairwise.D2_COLS),
                       "tol_rule": f"|Δw| ≤ tol + w·√({D2_RTOL:g}·(‖x_i‖²+"
                                   f"‖y_j‖²))/(2σ²)",
                       "note": "library_ms is torch.cdist(x, x): the "
                               "distances only, no RBF",
                       "err_over_tol": over,
                       **timed(kern, plain, lambda: torch.cdist(x, x)),
                       "bound": bound_ms(4.0 * (n * D + n + n * n),
                                         2.0 * n * n * D + 6.0 * n * n)}
        if label == "P×P":
            m = len(xp)
            times = timed(kern, plain, lambda: torch.cdist(xp, xp))
            records["P×P"] = {
                **pairwise.launch_plan("rbf_affinity", m, m, D, same=True),
                **{key: times[key] for key in ("ms", "plain_ms",
                                               "library_ms", "rounds")},
                "bound_ms": bound_ms(4.0 * (m * D + m + m * m),
                                     2.0 * m * m * D + 6.0 * m * m)[0]}
            print(f"rbf_affinity [P×P, {m} rows]: {times['ms']:.4f} ms "
                  f"({records['P×P']['rows_per_block']}-row tiles), plain "
                  f"{times['plain_ms']:.4f} ms, torch.cdist "
                  f"{times['library_ms']:.4f} ms")
    print(f"rbf_affinity: {records['ms']:.4f} ms; library torch.cdist(x, x) "
          f"{records['library_ms']:.4f} ms computes the distances only")
    return records


def pairwise_reg_phase(W_path) -> dict:
    """K10 on the path's block and a ragged one, against its plain version
    and against K1 at (1, 0, 0)."""
    import numpy as np
    import torch
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import ref

    rng = np.random.default_rng(2)
    W_ragged = rng.random((1000, 1000), dtype=np.float32) * (
        rng.random((1000, 1000)) < 0.02)
    records = {}
    for label, W_np in (("path", W_path), ("ragged", W_ragged)):
        B, C = W_np.shape[0], 39
        logp, W, _ = kernel_inputs(B, C, W_np, seed=B + 2)
        logp, W = logp[0], W[0]
        p = torch.exp(logp)

        def kern():
            return gr.reg_pairwise(logp, W, p=p)

        def plain():
            return ref.graph_reg_pairwise_ref(logp, W)

        a, b, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"graph_reg_pairwise [{label} B={B}]: two "
              "launches on the same inputs differ")
        rec = compare(f"graph_reg_pairwise [{label} B={B} C={C}]", a, want)
        k1 = gr.reg_forward(logp[None], W[None], 1.0, 0.0, 0.0)[0]
        print(f"graph_reg_pairwise [{label}]: K10 {a.item()!r}, K1 at "
              f"(1, 0, 0) {k1.item()!r}, bit-identical {torch.equal(a, k1)}")
        check(torch.equal(a, k1), f"K10 is not K1 at (1, 0, 0) bit for bit "
              f"[{label} B={B}]")
        if label == "path":
            s_flops = 2.0 * B * B * C
            records = dict(rec, **timed(kern, plain),
                           **gr.launch_plan("graph_reg_fwd", 1, B, C),
                           bound=bound_ms(4.0 * (B * B + 2 * B * C + 1),
                                          s_flops + 2.0 * B * B))
    return records


def ops_path(name: str, fn) -> dict:
    """Call one ``ops`` entry with the counts at 0 just before and read just
    after: ``name`` must launch once and nothing else."""
    import torch
    from repro_torch.kernels import graph_reg as gr
    gr.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    print(f"ops path of {name}: launches {counts}")
    check(counts == {n: int(n == name) for n in counts},
          f"the ops entry of {name} launched {counts}")
    return counts


def timed(kern, plain, library=None, rounds: int = 2, floor=None) -> dict:
    """Device time of a kernel's wrapper (as the path calls it), of its
    plain version and, where there is one, of one PyTorch call for the
    same function (and of a ``floor``, work the kernel cannot do without,
    where one is given): each from a CUDA graph of back-to-back calls
    (``bench.graph_ms``, no host time between launches), ``rounds``
    rounds in turns, averaged.  Every row of the kernels line is timed
    so."""
    from repro_torch.bench import graph_ms
    fns = {"ms": kern, "plain_ms": plain, "library_ms": library,
           "floor_ms": floor}
    runs = {key: [] for key, fn in fns.items() if fn is not None}
    for _ in range(rounds):
        for key in runs:
            runs[key].append(graph_ms(fns[key]))
    return {"library_ms": None,
            **{key: sum(v) / len(v) for key, v in runs.items()},
            "rounds": runs}


def pass_ms(fn, names: tuple, reps: int = 20) -> dict:
    """Device ms a call of ``fn`` spends in each kernel named in
    ``names`` (a kernel's passes): ``torch.profiler`` over ``reps`` calls
    after one warm-up, each kernel's device time over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        for name in names:
            if name in evt.key:
                out[name] += us / 1e3 / reps
    return out


def kernel_phase(W_path, gamma: float, kappa: float) -> dict:
    """Check, repeat and time K1-K3; return the per-kernel records at the
    path's shape."""
    import numpy as np
    import torch
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
        # The wrappers are given p, as the autograd Functions give it.
        pk = torch.exp(logp)
        # One PyTorch call for K3's function: addmm of P·logPᵀ onto ge·H
        # broadcast, scaled by -g (g is a known float here).
        H = -(pk[0] * logp[0]).sum(-1, keepdim=True).expand(B, B)
        gv = float(g[0])
        runs = {
            "graph_reg_fwd": (
                lambda: gr.reg_forward(logp, W, gc, kap, ge, p=pk),
                lambda: ref.reg_forward_ref(logp, W, gc, kap, ge), None),
            "graph_reg_bwd_dlogp": (
                lambda: gr.reg_bwd_dlogp(logp, W, g, gc, kap, ge, p=pk),
                lambda: ref.reg_bwd_dlogp_ref(logp, W, g, gc, kap, ge), None),
            "graph_reg_bwd_dw": (
                lambda: gr.reg_bwd_dw(logp, g, gc, ge, p=pk),
                lambda: ref.reg_bwd_dw_ref(logp, g, gc, ge),
                lambda: torch.addmm(H, pk[0], logp[0].T, beta=-gv * ge,
                                    alpha=-gv * gc)),
        }
        for name, (kern, plain, library) in runs.items():
            a, b, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{name} [{label} B={B}]: two launches "
                  "on the same inputs differ")
            rec = compare(f"{name} [{label} B={B} C={C}]", a, want)
            if label == "path":
                records[name] = dict(rec, **timed(kern, plain, library))
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
            records["graph_reg_bwd_dw"]["library"] = "torch.addmm"
            f4 = 4.0
            s_flops = 2.0 * B * B * C
            for name in ("graph_reg_fwd", "graph_reg_bwd_dlogp"):
                records[name].update(gr.launch_plan(name, 1, B, C))
            # The paper's shape keeps K1's row plan and K2's row route.
            check(records["graph_reg_fwd"]["class_chunk"] == 0
                  and records["graph_reg_bwd_dlogp"]["class_span"] == 0,
                  f"K1 or K2 at the paper's shape (1, {B}, {C}) leaves the "
                  f"row plan")
            records["graph_reg_fwd"]["bound"] = bound_ms(
                f4 * (B * B + B * C + 1), s_flops + 2.0 * B * B + 4.0 * B * C)
            records["graph_reg_bwd_dlogp"]["bound"] = bound_ms(
                f4 * (B * B + 2 * B * C + 1), 2 * s_flops + B * B + 8.0 * B * C)
            records["graph_reg_bwd_dw"]["bound"] = bound_ms(
                f4 * (B * C + B * B + 1), s_flops + 3.0 * B * B + 2.0 * B * C)
    return records


def masked_block(B: int, bt: int, seed: int, density: float = 0.25,
                 empty_line: int | None = None):
    """A (B, B) W, zero outside a random symmetric tile mask (optionally
    with one empty tile row and column)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nt = -(-B // bt)
    occ = rng.random((nt, nt)) < density
    occ = occ | occ.T
    if empty_line is not None:
        occ[empty_line, :] = occ[:, empty_line] = False
    W = rng.random((B, B), dtype=np.float32)
    mask = np.kron(occ, np.ones((bt, bt), bool))[:B, :B]
    return np.where(mask, (W + W.T) / 2, 0.0).astype(np.float32)


def layout_tensors(lay):
    import torch
    return [torch.from_numpy(a)[None].cuda() for a in lay.arrays()]


def active_entries(lay, B: int) -> int:
    """Entries of W inside the listed (valid) tiles, clipped to B: the work
    the block-sparse kernels must do for this layout."""
    bt = lay.bt
    side = [min(bt, B - t * bt) for t in range(lay.nt)]
    return sum(side[r] * side[c] for r, c, v in
               zip(lay.rows, lay.cols, lay.valid) if v == 1)


def bsp_kernel_phase(W_path, gamma: float, kappa: float) -> dict:
    """Check, repeat and time K4-K7; return the per-kernel records at the
    path's shape and layout."""
    import numpy as np
    import torch
    from repro_torch.core.metabatch import block_layout, layout_from_occupancy
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import graph_reg_bsp as bsp
    from repro_torch.kernels import ref

    P, C = W_path.shape[0], 39
    nt_path = -(-P // LAYOUT_BT)
    full = layout_from_occupancy(np.ones((nt_path, nt_path), bool), LAYOUT_BT)
    cases = (
        ("path", W_path, block_layout(W_path, LAYOUT_BT), gamma, kappa, None),
        ("path κ=1e-2 g=0.5", W_path, block_layout(W_path, LAYOUT_BT), 0.8,
         1e-2, 0.5),
        ("ragged bt=64", masked_block(1000, 64, 5), None, gamma, kappa, None),
        ("empty tile row bt=64", masked_block(1000, 64, 6, empty_line=7),
         None, 0.8, 1e-2, 0.5),
        ("full mask", W_path, full, gamma, kappa, None),
    )
    records = {}
    for label, W_np, lay, gc, kap, g_val in cases:
        B = W_np.shape[0]
        lay = block_layout(W_np, 64) if lay is None else lay
        bt = lay.bt
        logp, W, g = kernel_inputs(B, C, W_np, seed=B + 1, g=g_val)
        rows, cols, valid, crows, ccols, cvalid, occ = layout_tensors(lay)
        ge = gc
        p = torch.exp(logp)
        bterm = ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid, bt)
        # The wrappers are given p, as the autograd Function gives it;
        # the dense Wᵀ·P and W·logP stand beside K5 and K6 as their
        # library yardsticks (one PyTorch call for their products alone).
        runs = {
            "graph_reg_bsp_fwd": (
                lambda: bsp.bsp_forward(logp, W, rows, cols, valid, bt, gc,
                                        kap, ge, p=p),
                lambda: ref.bsp_forward_ref(logp, W, rows, cols, valid, bt,
                                            gc, kap, ge), None),
            "graph_reg_bsp_bterm": (
                lambda: bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt,
                                          p=p),
                lambda: ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid,
                                              bt),
                lambda: torch.bmm(W.mT, p)),
            "graph_reg_bsp_dlogp": (
                lambda: bsp.bsp_bwd_dlogp(logp, W, bterm, rows, cols, valid,
                                          g, bt, gc, kap, ge, p=p),
                lambda: ref.bsp_bwd_dlogp_ref(logp, W, bterm, rows, cols,
                                              valid, g, bt, gc, kap, ge),
                lambda: torch.bmm(W, logp)),
            "graph_reg_bsp_dw": (
                lambda: bsp.bsp_bwd_dw(logp, occ, g, bt, gc, ge, p=p),
                lambda: ref.bsp_bwd_dw_ref(logp, occ, g, bt, gc, ge), None),
        }
        where = (f"{label} B={B} C={C} bt={bt} "
                 f"{lay.n_active}/{lay.nt ** 2} tiles")
        # K7's floor: the fill of its dense (k, B, B) output with zeros,
        # which it cannot skip (not a library call for its function).
        dw_out = torch.empty(1, B, B, device="cuda")
        floors = {"graph_reg_bsp_dw": lambda: dw_out.zero_()}
        for name, (kern, plain, library) in runs.items():
            a, b, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{name} [{where}]: two launches on the "
                  "same inputs differ")
            rec = compare(f"{name} [{where}]", a, want)
            if label == "path":
                records[name] = dict(rec, **timed(kern, plain, library,
                                                  floor=floors.get(name)))
        dW = runs["graph_reg_bsp_dw"][0]()
        live = occ.repeat_interleave(bt, -2).repeat_interleave(bt, -1)
        check(bool((dW[live[..., :B, :B] == 0] == 0).all()),
              f"graph_reg_bsp_dw [{where}]: nonzero off the occupied tiles")
        if label == "full mask":
            k1 = gr.reg_forward(logp, W, gc, kap, ge)
            k4 = runs["graph_reg_bsp_fwd"][0]()
            check(torch.equal(k4, k1), f"K4 {k4.item()!r} is not K1 "
                  f"{k1.item()!r} bit for bit on the full mask")
            print(f"full mask: K4 == K1 bit for bit ({k4.item()!r})")
            k56 = bsp.bsp_bwd_dlogp(
                logp, W, bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt),
                rows, cols, valid, g, bt, gc, kap, ge)
            k2 = gr.reg_bwd_dlogp(logp, W, g, gc, kap, ge)
            k7, k3 = dW, gr.reg_bwd_dw(logp, g, gc, ge)
            check(torch.equal(k56, k2), "K5∘K6 is not K2 bit for bit on "
                  "the full mask")
            check(torch.equal(k7, k3), "K7 is not K3 bit for bit on the "
                  "full mask")
            print("full mask: K5∘K6 == K2 and K7 == K3 bit for bit")
        if label == "path":
            records["graph_reg_bsp_bterm"].update(
                library="torch.bmm(W.mT, p)",
                dynamic_smem_bytes=bsp.bterm_smem_bytes(B, C, lay.list_len,
                                                        bt))
            records["graph_reg_bsp_dlogp"]["library"] = "torch.bmm(W, logp)"
            for name in ("graph_reg_bsp_fwd", "graph_reg_bsp_dlogp"):
                records[name].update(bsp.launch_plan(name, 1, B, C,
                                                     lay.list_len, bt))
            n_el, T, nt = active_entries(lay, B), lay.list_len, lay.nt
            s_flops = 2.0 * n_el * C
            f4 = 4.0
            records["graph_reg_bsp_fwd"]["bound"] = bound_ms(
                f4 * (n_el + B * C + 3 * T + 1),
                s_flops + 2.0 * n_el + 4.0 * B * C)
            records["graph_reg_bsp_bterm"]["bound"] = bound_ms(
                f4 * (n_el + 2 * B * C + 3 * T), s_flops)
            records["graph_reg_bsp_dlogp"]["bound"] = bound_ms(
                f4 * (n_el + 3 * B * C + 3 * T + 1),
                s_flops + n_el + 8.0 * B * C)
            records["graph_reg_bsp_dw"]["bound"] = bound_ms(
                f4 * (B * C + nt * nt + 1 + B * B),
                s_flops + 3.0 * n_el + 2.0 * B * C)
            print(f"path layout: bt={bt}, {lay.n_active} of {nt * nt} tiles "
                  f"occupied, list length {T}, {n_el} entries of W in them")
            k7 = records["graph_reg_bsp_dw"]
            print(f"graph_reg_bsp_dw [path]: {k7['ms']:.5f} ms; its floor, "
                  f"zero_ of the same (1, {B}, {B}) output, "
                  f"{k7['floor_ms']:.5f} ms; bound {k7['bound'][0]:.5f} ms "
                  f"({k7['bound'][1]}); plain {k7['plain_ms']:.5f} ms")
            # Where K7's time goes: its zero pieces alone (an empty mask),
            # one occupied tile (two live pieces, at the grid's start or
            # its end) and every tile (K3's work and the occupancy tests).
            from repro_torch.bench import graph_ms
            masks = {"empty": [], "first tile": [(0, 0)],
                     "last tile": [(nt - 1, nt - 1)],
                     "full": [(r, c) for r in range(nt) for c in range(nt)]}
            k7["by_mask_ms"] = {}
            for key, cells in masks.items():
                o = torch.zeros(1, nt, nt, dtype=torch.int32, device="cuda")
                for r, c in cells:
                    o[0, r, c] = 1
                k7["by_mask_ms"][key] = graph_ms(
                    lambda o=o: bsp.bsp_bwd_dw(logp, o, g, bt, gc, ge, p=p))
            print(f"graph_reg_bsp_dw by occupancy (same inputs): "
                  + ", ".join(f"{key} {ms:.5f} ms" for key, ms in
                              k7["by_mask_ms"].items()))
    return records


def random_logp(k: int, B: int, C: int, seed: int):
    """log-softmax of seeded normal logits, (k, B, C) on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.log_softmax(torch.from_numpy((2.0 * rng.standard_normal(
        (k, B, C))).astype(np.float32)).cuda(), -1).contiguous()


def sparse_w(k: int, B: int, seed: int):
    """A seeded random (k, B, B) affinity block, 5 % of it nonzero."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((k, B, B), dtype=np.float32) * (
        rng.random((k, B, B)) < 0.05)).astype(np.float32)).cuda()


#: Tile masks of K4's and K6's cases: one tile row empty; one tile row
#: holding every tile (and nothing else); a random mask whose lists carry
#: tail padding beyond the longest worker's; every tile occupied.
MASK_KINDS = ("empty tile row", "one full tile row", "tail-padded", "full")


def bsp_case(k: int, B: int, bt: int, kind: str, seed: int):
    """k workers' W (k, B, B) on the card, uniform in [0, 1) inside a tile
    mask of ``kind`` (:data:`MASK_KINDS`) and zero outside it, and the
    seven layout arrays with the worker axis leading (one list length for
    all).  W is not symmetric: with a symmetric W and C = 1 (logp = 0, p
    = 1) K6's output is g·(κ + γ·(deg_i − Σ_j W_ji)), a difference of two
    equal sums that the kernel and its plain version take in different
    orders, which no tolerance relative to the output bounds."""
    import numpy as np
    import torch
    from repro_torch.core.metabatch import block_layout
    rng = np.random.default_rng(seed)
    nt = -(-B // bt)
    Ws = []
    for _ in range(k):
        if kind == "one full tile row":
            occ = np.zeros((nt, nt), bool)
            occ[nt // 2] = True
        else:
            occ = rng.random((nt, nt)) < (2.0 if kind == "full" else 0.3)
            if kind == "empty tile row":
                occ[min(1, nt - 1)] = False
        mask = np.kron(occ, np.ones((bt, bt), bool))[:B, :B]
        Ws.append(np.where(mask, rng.random((B, B), dtype=np.float32),
                           0.0).astype(np.float32))
    T = max(block_layout(w, bt).list_len for w in Ws)
    T += 7 if kind == "tail-padded" else 0
    lays = [block_layout(w, bt, list_len=T).arrays() for w in Ws]
    arrays = [torch.from_numpy(np.stack([lay[i] for lay in lays])).cuda()
              for i in range(7)]
    return torch.from_numpy(np.stack(Ws)).cuda(), arrays


def redesign_cases_phase(P: int) -> int:
    """The redesigned kernels beyond the path's shape: K1 and K2 at k in
    {1, 3}, B in {1, 31, 33, 1000, 1001}, C in {1, 39, 100, 128, 200}, K10 ==
    K1 at (1, 0, 0) at B = 1001; K3 and K5 at k = 2 workers,
    ragged B (1000, and 1001 for rows that are not 16-byte multiples), C
    in {1, 39, 100}, K5 at bt in {32, 64, 128} on random symmetric tile
    masks and on a full mask at bt = 32, C = 128, B = 6144; K4 and K6 at
    the K1/K2 shapes, bt in {32, 64, 128, 256} and every mask of
    :data:`MASK_KINDS`; each against its plain version and repeated bit
    for bit.  Returns the number of cases."""
    import numpy as np
    import torch
    from repro_torch.core.metabatch import block_layout
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import graph_reg_bsp as bsp
    from repro_torch.kernels import ref

    logp_of = random_logp

    def run(where, kern, plain):
        a, b, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{where}: two launches differ")
        compare(where, a, want)

    n = 0
    # K1 and K2 at ragged and edge shapes, on a random sparse W per
    # worker (C = 200 takes two of K2's class chunks), and K10 == K1 at
    # (1, 0, 0) at B = 1001.
    for k in (1, 3):
        for B in (1, 31, 33, 1000, 1001):
            W = sparse_w(k, B, seed=B + k)
            for C in (1, 39, 100, 128, 200):
                logp = logp_of(k, B, C, seed=B + C + k)
                g = torch.tensor([0.5, -2.0, 0.25][:k], device="cuda")
                run(f"graph_reg_fwd [k={k} B={B} C={C}]",
                    lambda: gr.reg_forward(logp, W, 0.8, 1e-2, 0.8),
                    lambda: ref.reg_forward_ref(logp, W, 0.8, 1e-2, 0.8))
                run(f"graph_reg_bwd_dlogp [k={k} B={B} C={C}]",
                    lambda: gr.reg_bwd_dlogp(logp, W, g, 0.8, 1e-2, 0.8),
                    lambda: ref.reg_bwd_dlogp_ref(logp, W, g, 0.8, 1e-2,
                                                  0.8))
                n += 2
    logp = logp_of(1, 1001, 39, seed=17)[0]
    W = torch.from_numpy(np.random.default_rng(17).random(
        (1001, 1001), dtype=np.float32)).cuda()
    k10 = gr.reg_pairwise(logp, W)
    check(torch.equal(k10, gr.reg_forward(logp[None], W[None], 1.0, 0.0,
                                          0.0)[0]),
          "K10 is not K1 at (1, 0, 0) bit for bit [B=1001]")
    for k, B, C in ((2, 1000, 1), (2, 1000, 39), (2, 1000, 100),
                    (2, P, 39), (1, 1001, 39)):
        logp = logp_of(k, B, C, seed=B + C)
        g = torch.tensor([0.5, -2.0][:k], device="cuda")
        run(f"graph_reg_bwd_dw [k={k} B={B} C={C}]",
            lambda: gr.reg_bwd_dw(logp, g, 0.8, 0.8),
            lambda: ref.reg_bwd_dw_ref(logp, g, 0.8, 0.8))
        n += 1
    for bt in (32, 64, 128):
        for k, B, C in ((2, 1000, 1), (2, 1000, 39), (2, 1000, 100),
                        (1, 1001, 39)):
            Ws = [masked_block(B, bt, seed=bt + C + z, density=0.25,
                               empty_line=z if z else None)
                  for z in range(k)]
            T = max(block_layout(w, bt).list_len for w in Ws)
            lays = [block_layout(w, bt, list_len=T).arrays() for w in Ws]
            crows, ccols, cvalid = (torch.from_numpy(np.stack(
                [lay[i] for lay in lays])).cuda() for i in (3, 4, 5))
            W = torch.from_numpy(np.stack(Ws)).cuda()
            logp = logp_of(k, B, C, seed=B + bt + C)
            run(f"graph_reg_bsp_bterm [k={k} B={B} C={C} bt={bt}]",
                lambda: bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt),
                lambda: ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid,
                                              bt))
            n += 1
    # A long list: a full mask at bt = 32 and C = 128 lists 36,864 tiles;
    # K5's shared memory holds one strip's 192, not the list.
    B, C, bt = 6144, 128, 32
    lay = block_layout(masked_block(B, bt, seed=7, density=2.0), bt)
    crows, ccols, cvalid = (torch.from_numpy(a)[None].cuda()
                            for a in lay.arrays()[3:6])
    W = torch.from_numpy(masked_block(B, bt, seed=7, density=2.0))[None].cuda()
    logp = logp_of(1, B, C, seed=B + C)
    smem = bsp.bterm_smem_bytes(B, C, lay.list_len, bt)
    run(f"graph_reg_bsp_bterm [full mask B={B} C={C} bt={bt}, list length "
        f"{lay.list_len}, {smem} bytes of shared memory]",
        lambda: bsp.bsp_bwd_bterm(logp, W, crows, ccols, cvalid, bt),
        lambda: ref.bsp_bwd_bterm_ref(logp, W, crows, ccols, cvalid, bt))
    n += 1
    # K4 and K6 at ragged and edge shapes, tile edges and masks: each
    # against its plain version (K6 on K5's plain bterm) and repeated bit
    # for bit; printed as one line a tile edge.
    for bt in (32, 64, 128, 256):
        worst, n_bt = {"K4": 0.0, "K6": 0.0}, 0
        for k in (1, 3):
            for B in (1, 31, 33, 1000, 1001):
                for kind in MASK_KINDS:
                    W, (rows, cols, valid, crows, ccols, cvalid,
                        _) = bsp_case(k, B, bt, kind, seed=B + bt + k)
                    for C in (1, 39, 100, 128, 200):
                        logp = logp_of(k, B, C, seed=B + C + bt)
                        g = torch.tensor([0.5, -2.0, 0.25][:k], device="cuda")
                        bterm = ref.bsp_bwd_bterm_ref(logp, W, crows, ccols,
                                                      cvalid, bt)
                        where = f"k={k} B={B} C={C} bt={bt} {kind}"
                        for key, kern, plain in (
                                ("K4", lambda: bsp.bsp_forward(
                                    logp, W, rows, cols, valid, bt, 0.8, 1e-2,
                                    0.8),
                                 lambda: ref.bsp_forward_ref(
                                     logp, W, rows, cols, valid, bt, 0.8,
                                     1e-2, 0.8)),
                                ("K6", lambda: bsp.bsp_bwd_dlogp(
                                    logp, W, bterm, rows, cols, valid, g, bt,
                                    0.8, 1e-2, 0.8),
                                 lambda: ref.bsp_bwd_dlogp_ref(
                                     logp, W, bterm, rows, cols, valid, g, bt,
                                     0.8, 1e-2, 0.8))):
                            a, b, want = kern(), kern(), plain()
                            torch.cuda.synchronize()
                            check(torch.equal(a, b),
                                  f"{key} [{where}]: two launches differ")
                            rec = compare(f"{key} [{where}]", a, want,
                                          quiet=True)
                            worst[key] = max(worst[key], rec["err_over_tol"])
                            n_bt += 1
        print(f"K4 and K6 at bt={bt}: {n_bt} cases (k 1/3, B 1/31/33/1000/"
              f"1001, C 1/39/100/128/200, masks: {', '.join(MASK_KINDS)}) "
              f"within tolerance, repeated bit for bit; worst err/tol K4 "
              f"{worst['K4']:.3f}, K6 {worst['K6']:.3f}")
        n += n_bt
    # K7 on K3's tile at ragged shapes (B not a multiple of 4: scalar
    # stores), tile edges (pieces over several tiles below bt = 128) and
    # masks: within tolerance, repeated bit for bit, exact zeros off the
    # occupied tiles, K3's bits on a full mask.  gc != ge: at B = 1 the
    # one entry is -g·h·(ge - gc), which no relative tolerance bounds when
    # they are equal.
    for bt in (32, 64, 96, 128, 160, 256):
        worst, n_bt, n_full = 0.0, 0, 0
        for k in (1, 3):
            g = torch.tensor([0.5, -2.0, 0.25][:k], device="cuda")
            for B in (1, 33, 130, 1000, 1001):
                for kind in MASK_KINDS:
                    _, arrays = bsp_case(k, B, bt, kind, seed=B + bt + k)
                    occ = arrays[6]
                    live = occ.repeat_interleave(bt, -2).repeat_interleave(
                        bt, -1)[..., :B, :B]
                    for C in (1, 39, 200):
                        logp = logp_of(k, B, C, seed=B + C + bt)
                        where = f"K7 [k={k} B={B} C={C} bt={bt} {kind}]"
                        a = bsp.bsp_bwd_dw(logp, occ, g, bt, 0.8, 0.5)
                        b = bsp.bsp_bwd_dw(logp, occ, g, bt, 0.8, 0.5)
                        want = ref.bsp_bwd_dw_ref(logp, occ, g, bt, 0.8, 0.5)
                        torch.cuda.synchronize()
                        check(torch.equal(a, b), f"{where}: two launches "
                              "differ")
                        check(bool((a[live == 0] == 0).all()),
                              f"{where}: nonzero off the occupied tiles")
                        rec = compare(where, a, want, quiet=True)
                        worst = max(worst, rec["err_over_tol"])
                        if kind == "full":
                            check(torch.equal(a, gr.reg_bwd_dw(
                                logp, g, 0.8, 0.5)), f"{where}: not K3 bit "
                                "for bit on the full mask")
                            n_full += 1
                        n_bt += 1
        print(f"K7 at bt={bt}: {n_bt} cases (k 1/3, B 1/33/130/1000/1001, "
              f"C 1/39/200, masks: {', '.join(MASK_KINDS)}) within "
              f"tolerance, repeated bit for bit, zero off the occupied "
              f"tiles, {n_full} equal to K3 on a full mask; worst err/tol "
              f"{worst:.3f}")
        n += n_bt
    print(f"redesigned K1, K2, K3, K4, K5, K6 and K7: {n} further cases "
          f"within tolerance and repeated bit for bit")
    return n


def small_step_parity(layout_bt: int | None = None) -> None:
    """One full step with the GPU kernels against the CPU plain path; with
    ``layout_bt`` the batch carries each worker's block layout, and the
    step must run on K4, K5 and K6."""
    import numpy as np
    import torch
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.core.metabatch import block_layout, tile_occupancy
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels.tuning import TileSpec
    from repro_torch.models.dnn import DNNConfig, init_dnn
    from repro_torch.optim import adagrad
    from repro_torch.train.train_step import _TILE_KEYS, dnn_ssl_step

    rng = np.random.default_rng(7)
    k, P, D, C = 2, 200, 24, 39
    cfg = DNNConfig(input_dim=D, hidden_dim=64, n_hidden=2, n_classes=C,
                    dropout=0.0)
    if layout_bt is None:
        W = rng.random((k, P, P), dtype=np.float32)
        W = (W + W.transpose(0, 2, 1)) * (rng.random((k, P, P)) < 0.05)
    else:
        W = np.stack([masked_block(P, layout_bt, seed=z, density=0.4)
                      for z in range(k)])
    valid = np.ones((k, P), bool)
    valid[:, 180:] = False
    batch = {"x": rng.standard_normal((k, P, D)).astype(np.float32),
             "y": rng.integers(0, C, (k, P)),
             "label_mask": (rng.random((k, P)) < 0.3).astype(np.float32),
             "W": W.astype(np.float32), "valid": valid}
    tiles = None
    if layout_bt is not None:
        T = max(block_layout(w, layout_bt).list_len for w in W)
        lays = [block_layout(w, layout_bt, list_len=T).arrays() for w in W]
        batch.update({key: np.stack([lay[i] for lay in lays])
                      for i, key in enumerate(_TILE_KEYS)})
        tiles = TileSpec(bi=layout_bt)
        check(all(tile_occupancy(w, layout_bt).sum() < lay[6].size
                  for w, lay in zip(W, lays)), "the layout skips no tile")
    params0 = to_numpy(init_dnn(cfg, 3))
    hyper = SSLHyper(gamma=1.0, kappa=1e-4, weight_decay=1e-5)
    out = {}
    for dev in ("cuda", "cpu"):
        params = to_torch(params0, dev)
        opt = adagrad()
        state = opt.init(params)
        b = {key: torch.from_numpy(np.asarray(v)).to(dev)
             for key, v in batch.items()}
        gr.reset_launch_counts()
        params, state, metrics = dnn_ssl_step(
            params, state, b, cfg=cfg, hyper=hyper, opt=opt, lr=1e-3,
            pairwise=resolve_pairwise("auto", tiles=tiles))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {n: c for n, c in gr.launch_counts().items() if c}
            want = (["graph_reg_fwd", "graph_reg_bwd_dlogp"]
                    if layout_bt is None else
                    ["graph_reg_bsp_fwd", "graph_reg_bsp_bterm",
                     "graph_reg_bsp_dlogp"])
            check(counts == dict.fromkeys(want, 1),
                  f"small step launched {counts}, not {want} once each")
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
    print(f"small-step parity (k={k}, P={P}, C={C}, layout_bt={layout_bt}): "
          f"loss/total gpu={out['cuda'][0]['loss/total']:.6f} "
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


def train_phase(exp, kernels: tuple[str, ...], label: str) -> dict:
    """One epoch of ``exp`` on the card; each of ``kernels`` must launch
    once per step and no other kernel at all."""
    import numpy as np
    from repro_torch.kernels import graph_reg as gr

    timed = TimedPipeline(exp.pipeline, exp.config.execution.prefetch)
    exp.pipeline = timed
    gr.reset_launch_counts()
    res = exp.run()
    counts = gr.launch_counts()
    exp.pipeline = timed.inner
    check(len(res.history) == 1, f"{label}: the epoch produced no history row")
    row = res.history[0]
    print(f"{label} epoch row: " + json.dumps(row))
    steps = timed.n
    check(timed.steady_steps >= 2, f"{label}: too few steps ({steps}) to time")
    steady = (timed.t_end - timed.t_steady) / timed.steady_steps
    print(f"{label}: {steps} steps, {1e3 * steady:.3f} ms/step over steps "
          f"1..{timed.steady_steps} (host clock, prefetch {timed.d}), host "
          f"batch assembly {1e3 * timed.host_s / steps:.3f} ms/step, "
          f"launches {counts}")
    check(np.isfinite(row["loss/total"]) and np.isfinite(row["eval/acc"]),
          f"{label}: non-finite loss/total or eval/acc")
    want = {name: (steps if name in kernels else 0) for name in counts}
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          "(each path kernel once per step, no other kernel)")
    return {"counts": counts, "steps": steps, "steady_ms": 1e3 * steady,
            "host_ms": 1e3 * timed.host_s / steps, "row": row,
            "params": res.params}


def device_weights_phase(exp, exp_dev, dev_row: dict) -> None:
    """Why the epoch on the device-built graph ends with another loss than
    the host graph's: one epoch on the host graph's edges and plan with
    the device graph's weights in place of the host's.  If its loss/total
    is the device epoch's bit for bit, the weights' round-off is the whole
    difference.  A measurement, not a check."""
    import numpy as np
    from repro_torch.api import Experiment
    from repro_torch.bench import paper_config
    from repro_torch.core.affinity import AffinityGraph

    g_host, g_dev = exp.graph, exp_dev.graph
    same = (np.array_equal(g_host.W.indptr, g_dev.W.indptr)
            and np.array_equal(g_host.W.indices, g_dev.W.indices))
    if not same:
        print("device weights on the host graph: the two graphs' edges "
              "differ, not measured")
        return
    W = g_host.W.copy()
    W.data = g_dev.W.data.copy()
    mixed = Experiment(paper_config(), corpus=exp.corpus,
                       eval_data=exp.eval_data,
                       graph=AffinityGraph(W=W, k=g_host.k,
                                           sigma=g_host.sigma),
                       plan=exp.plan, device="cuda").build()
    row = train_phase(mixed, ("graph_reg_fwd", "graph_reg_bwd_dlogp"),
                      "host graph with the device weights")["row"]
    print(f"host graph's edges and plan with the device graph's weights: "
          f"loss/total {row['loss/total']!r}, device-graph epoch "
          f"{dev_row['loss/total']!r}: bit-equal "
          f"{row['loss/total'] == dev_row['loss/total']}")


def w_grad_path(W_path, gamma: float, kappa: float,
                layout_bt: int | None = None) -> dict:
    """The regularizer's VJP with respect to W (what graph-weight learning
    asks for), through the ``"auto"`` registry entry a user calls, at the
    main path's shape, with the block layout of W when ``layout_bt`` is
    given.  Counts at 0 just before, read just after: K3's and K7's only
    path, since training never needs dW."""
    import torch
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.core.metabatch import block_layout
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels.tuning import TileSpec

    logp, W, _ = kernel_inputs(W_path.shape[0], 39, W_path, seed=3)
    logp.requires_grad_(True)
    W.requires_grad_(True)
    if layout_bt is None:
        fn, kw = resolve_pairwise("auto"), {}
        want = ("graph_reg_fwd", "graph_reg_bwd_dlogp", "graph_reg_bwd_dw")
    else:
        fn = resolve_pairwise("auto", tiles=TileSpec(bi=layout_bt))
        kw = {"layout": layout_tensors(block_layout(W_path, layout_bt))}
        want = ("graph_reg_bsp_fwd", "graph_reg_bsp_bterm",
                "graph_reg_bsp_dlogp", "graph_reg_bsp_dw")
    gr.reset_launch_counts()
    fn(logp, W, gamma, kappa, **kw).sum().backward()
    torch.cuda.synchronize()
    counts = gr.launch_counts()
    print(f"W-gradient path (layout_bt={layout_bt}): launches {counts}")
    check(counts == {name: int(name in want) for name in counts},
          f"the W-gradient path did not run {want} once each and nothing "
          "else")
    check(bool(torch.isfinite(W.grad).all() and torch.isfinite(logp.grad).all()),
          "non-finite gradients on the W-gradient path")
    return counts


def extras_config(**over):
    """``bench.paper_config()`` with sections replaced (``execution``,
    ``resilience``, ``batch``, ``online``, ``graph``, ``train``)."""
    import dataclasses
    from repro_torch.bench import paper_config
    return dataclasses.replace(paper_config(), **over)


def checkpoint_phase(exp) -> dict:
    """Checkpoint and resume at full width (the paper's configuration, 2
    epochs, ``checkpoint_every=1``), on the host experiment's corpus, graph
    and plan: an uninterrupted run; a run stopped after epoch 1 and
    resumed; and the uninterrupted run's directory with the file LATEST
    points at truncated by the injector's checkpoint fault, resumed from
    the checkpoint before it.  Each resumed run's final checkpoint (params,
    AdaGrad state, the dropout generator's state on the card, the step)
    and history must equal the uninterrupted run's bit for bit."""
    import dataclasses
    import shutil
    import warnings
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.resilience import FaultEvent, FaultInjector, FaultPlan

    root = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)

    def run(n_epochs: int, name: str, resume: bool = False):
        base = extras_config()
        cfg = dataclasses.replace(
            base, train=dataclasses.replace(base.train, n_epochs=n_epochs),
            execution=dataclasses.replace(
                base.execution, checkpoint_every=1,
                checkpoint_dir=str(root / name), resume=resume))
        e = Experiment(cfg, corpus=exp.corpus, eval_data=exp.eval_data,
                       graph=exp.graph, plan=exp.plan, device="cuda")
        gr.reset_launch_counts()
        res, secs = sync_time(e.run)
        return res, gr.launch_counts(), secs

    def rows(res):
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in res.history]

    def archive_equal(a: Path, b: Path) -> list[str]:
        """Keys of two checkpoints whose arrays differ in any bit."""
        with np.load(a) as x, np.load(b) as y:
            check(sorted(x.files) == sorted(y.files),
                  f"{a} and {b} hold different keys")
            return [key for key in x.files
                    if x[key].dtype != y[key].dtype
                    or not np.array_equal(x[key], y[key])]

    full, full_counts, full_s = run(2, "full")
    stop, _, _ = run(1, "stopped")
    resumed, res_counts, res_s = run(2, "stopped", resume=True)
    want = root / "full" / "ckpt_00002.npz"
    with np.load(want) as z:
        keys = z.files
        n_bytes = want.stat().st_size
        gen = z[next(key for key in keys if key.startswith("generator"))]
    print(f"checkpoint phase: uninterrupted 2 epochs {full_s:.2f}s, "
          f"launches {full_counts}; checkpoint {n_bytes / 1e6:.1f} MB, "
          f"{sum(not key.startswith('__dtype__') for key in keys)} arrays, "
          f"generator state {gen.dtype} ({gen.size} bytes) of a "
          f"{torch.cuda.get_device_name(0)} generator")
    steps = full_counts["graph_reg_fwd"] // 2
    check(res_counts == {name: (steps if name in ("graph_reg_fwd",
                                                 "graph_reg_bwd_dlogp")
                                else 0) for name in res_counts},
          f"the resumed run launched {res_counts}: not one epoch of K1/K2")
    differ = archive_equal(root / "stopped" / "ckpt_00002.npz", want)
    print(f"resume after epoch 1: {res_s:.2f}s, launches {res_counts}; "
          f"final checkpoint arrays differing from the uninterrupted run's: "
          f"{differ or 'none'}; history rows equal "
          f"{rows(resumed) == rows(full)}")
    check(not differ, f"the resumed run's final state differs: {differ}")
    check(rows(resumed) == rows(full), "the resumed run's history differs")
    check(rows(stop) == rows(full)[:1], "the stopped run's epoch differs")

    # A truncate fault on the file LATEST points at: resume falls back.
    shutil.copytree(root / "full", root / "corrupt")
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint", epoch=2,
                                              mode="truncate"),)))
    inj.after_checkpoint(str(root / "corrupt" / "ckpt_00002.npz"), epoch=2)
    check(len(inj.fired()) == 1, "the checkpoint fault did not fire")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fell, fell_counts, fell_s = run(2, "corrupt", resume=True)
    fallback = [str(w.message) for w in caught
                if "ckpt_00002 is unusable" in str(w.message)]
    differ = archive_equal(root / "corrupt" / "ckpt_00002.npz", want)
    print(f"resume past a truncated LATEST (ckpt_00002): warned "
          f"{len(fallback)} time(s) ({fallback[0][:90] if fallback else ''}"
          f"...), {fell_s:.2f}s, launches {fell_counts}; final checkpoint "
          f"arrays differing: {differ or 'none'}; history rows equal "
          f"{rows(fell) == rows(full)}")
    check(len(fallback) == 1, "resume did not fall back past the corrupt "
          "LATEST target")
    check(fell_counts == res_counts, f"the fallback resume launched "
          f"{fell_counts}, not one epoch")
    check(not differ and rows(fell) == rows(full),
          f"the fallback resume's final state or history differs: {differ}")
    shutil.rmtree(root)
    return {"steps": steps, "bytes": n_bytes, "full_s": full_s,
            "resume_s": res_s}


def guard_phase(exp, steps: int) -> dict:
    """The non-finite guard at full width: one epoch of the paper's
    configuration with a NaN batch at step 3 and an inf batch at step 11
    (fault injection), ``nonfinite_guard=True``.  Exactly the two steps
    are skipped, the params stay finite, and the launches are the epoch's
    plus one replay of each tainted window (``guard_window`` chunks of
    ``scan_chunk`` steps, cut at the epoch's end); the same faults without
    the guard leave the params non-finite."""
    import numpy as np
    from repro_torch.api import Experiment, ResilienceConfig
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.resilience import (FaultEvent, FaultInjector, FaultPlan,
                                        all_finite)

    poisoned = {3: "nan", 11: "inf"}

    def run(resilience):
        e = Experiment(extras_config(resilience=resilience),
                       corpus=exp.corpus, eval_data=exp.eval_data,
                       graph=exp.graph, plan=exp.plan, device="cuda",
                       injector=FaultInjector(FaultPlan(tuple(
                           FaultEvent("batch", epoch=0, step=s, mode=m)
                           for s, m in poisoned.items()))))
        gr.reset_launch_counts()
        res, secs = sync_time(e.run)
        return res, gr.launch_counts(), secs

    cfg = ResilienceConfig(nonfinite_guard=True)
    res, counts, secs = run(cfg)
    row = res.history[0]
    chunk = extras_config().execution.scan_chunk
    w = cfg.guard_window * chunk if chunk else steps
    replayed = sum(min(w, steps - s) for s in range(0, steps, w)
                   if any(s <= p < s + w for p in poisoned))
    want = {name: (steps + replayed if name in ("graph_reg_fwd",
                                                "graph_reg_bwd_dlogp")
                   else 0) for name in counts}
    finite = bool(all_finite(res.params))
    print(f"guard phase: NaN batch at step 3, inf at step 11, guard window "
          f"{cfg.guard_window} chunks of {chunk} steps ({w} steps): "
          f"guard/skipped_total {row['guard/skipped_total']}, "
          f"guard/skipped mean {row['guard/skipped']!r}, params finite "
          f"{finite}, loss/total {row['loss/total']!r}, {secs:.2f}s; "
          f"launches {counts} ({steps} steps + {replayed} replayed)")
    check(row["guard/skipped_total"] == 2, "the guard did not skip exactly "
          "the two poisoned steps")
    check(finite and np.isfinite(row["loss/total"]),
          "the guarded run ended non-finite")
    check(counts == want, f"guarded launches {counts}, expected {want}")
    bare, bare_counts, _ = run(ResilienceConfig())
    bare_finite = bool(all_finite(bare.params))
    print(f"the same faults without the guard: params finite {bare_finite}, "
          f"loss/total {bare.history[0]['loss/total']!r}, launches "
          f"{bare_counts}")
    check(not bare_finite, "the unguarded run stayed finite: the faults "
          "did not reach the params")
    return {"counts": counts, "replayed": replayed, "seconds": secs}


def online_phase(exp) -> dict:
    """The online graph refresh at full width: the paper's configuration
    on the stream pipeline, its graph built on K8 (``construction=
    "device"``) and refreshed on K8 after each of 2 epochs
    (``online.refresh_every=1``, ``backend="device"``) from the top hidden
    layer's activations (N 20,000 × D 2000).  K8 launches once for the
    build and once per refresh; the last refresh's graph is held against
    the host graph of the same embeddings (edges equal except at near
    ties), and K8 at that shape is checked and timed beside its bound."""
    import dataclasses
    import numpy as np
    from repro_torch.api import BatchConfig, Experiment, OnlineConfig
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.online.refresh import (edge_churn, edge_set,
                                            embedding_knn_graph)

    base = extras_config()
    cfg = dataclasses.replace(
        base,
        graph=dataclasses.replace(base.graph, construction="device"),
        batch=BatchConfig(batch_size=base.batch.batch_size,
                          pipeline="metabatch_stream"),
        train=dataclasses.replace(base.train, n_epochs=2),
        online=OnlineConfig(refresh_every=1, tap=-1, backend="device"))
    gr.reset_launch_counts()
    e, build_s = sync_time(lambda: Experiment(
        cfg, corpus=exp.corpus, eval_data=exp.eval_data,
        device="cuda").build())
    build_counts = gr.launch_counts()
    gr.reset_launch_counts()
    res, run_s = sync_time(e.run)
    run_counts = gr.launch_counts()
    stats, mgr = e.online.stats, e.online
    steps = run_counts["graph_reg_fwd"]
    print(f"online phase: build {build_s:.2f}s, launches {build_counts}; 2 "
          f"epochs with a refresh after each {run_s:.2f}s, launches "
          f"{run_counts}; stats {stats}; churn of the last refresh "
          f"{mgr.last_churn!r}; loss/total "
          f"{[r['loss/total'] for r in res.history]}")
    check(build_counts == {n: int(n == "knn_topk") for n in build_counts},
          f"the online experiment's build launched {build_counts}")
    check(run_counts == {n: (2 if n == "knn_topk" else steps if n in (
        "graph_reg_fwd", "graph_reg_bwd_dlogp") else 0) for n in run_counts},
          f"the online run launched {run_counts}: not K8 once per refresh")
    check(stats["refreshes"] == 2 and stats["rejected"] == 0,
          f"the refreshes did not both swap in: {stats}")
    check(all(np.isfinite(r["loss/total"]) for r in res.history),
          "non-finite loss/total on the online path")
    E = np.ascontiguousarray(mgr.features, np.float32)
    k = mgr.graph.k
    check(E.shape == (exp.corpus.X.shape[0], base.train.hidden_dim),
          f"embeddings of shape {E.shape}")
    t0 = time.perf_counter()
    g_host = embedding_knn_graph(E, k=k, backend="host")
    host_s = time.perf_counter() - t0
    a, b = edge_set(g_host), edge_set(mgr.graph)
    diff = a ^ b
    near = near_tie_rows(E, k)
    bad = [edge for edge in diff if not (near[edge[0]] or near[edge[1]])]
    rel = abs(mgr.graph.sigma - g_host.sigma) / g_host.sigma
    print(f"refreshed graph (K8) vs host graph of the same {E.shape} "
          f"embeddings (host build {host_s:.2f}s): sigma rel {rel:.2e}, "
          f"{len(b)} vs {len(a)} edges, symmetric difference {len(diff)} "
          f"(churn {edge_churn(g_host, mgr.graph):.2e}), "
          f"{int(near.sum())} near-tie rows, {len(bad)} differing edges at "
          f"no near-tie row")
    check(not bad, f"refreshed edges differ away from near ties: {bad[:10]}")
    check(rel <= 1e-5, f"refreshed sigma differs from the host's by {rel}")
    rec = knn_kernel_phase(E, k)
    print(f"knn_topk at the refresh's shape N={E.shape[0]} D={E.shape[1]} "
          f"k={k}: {rec['ms']:.3f} ms, bound {rec['bound'][0]:.3f} ms "
          f"({rec['bound'][1]}), {100 * rec['bound'][0] / rec['ms']:.1f} % "
          f"of it; plain {rec['plain_ms']:.3f} ms")
    return {"launches": {"build": build_counts["knn_topk"],
                         "refreshes": run_counts["knn_topk"]},
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
            "shape": list(E.shape), "k": k, "stats": stats,
            "churn": mgr.last_churn, "edge_diff": len(diff),
            "run_s": run_s}


def guard_overhead_phase(exp, pairs: int = 8) -> dict:
    """The guard's cost on a clean full-width epoch (the paper's
    configuration, no fault): epochs with the guard off and on in turns,
    ``pairs`` pairs, the first of a pair alternating (off-on, on-off, ...)
    so that a drift along the sequence cancels, at ``scan_chunk`` 1
    (windows of ``guard_window`` steps) and at the default; the median of
    the per-pair ratios of the epochs' seconds (the history row's wall
    time, which ends with the metric fetch).  Printed, not checked: the
    host's time varies between runs."""
    import dataclasses
    import statistics
    from repro_torch.api import Experiment, ResilienceConfig

    base = extras_config()

    def epoch_s(chunk: int, guard: bool) -> float:
        cfg = extras_config(
            execution=dataclasses.replace(base.execution, scan_chunk=chunk),
            resilience=ResilienceConfig(nonfinite_guard=guard))
        res = Experiment(cfg, corpus=exp.corpus, eval_data=exp.eval_data,
                         graph=exp.graph, plan=exp.plan,
                         device="cuda").run()
        return res.history[0]["seconds"]

    out = {}
    for chunk in (1, base.execution.scan_chunk):
        epoch_s(chunk, True)                     # warm-up, not counted
        times = []
        for i in range(pairs):
            first = epoch_s(chunk, bool(i % 2))
            second = epoch_s(chunk, not i % 2)
            times.append((second, first) if i % 2 else (first, second))
        ratios = [on / off for off, on in times]
        med = statistics.median(ratios)
        out[chunk] = {"median_ratio": med, "ratios": ratios,
                      "off_s": [t[0] for t in times],
                      "on_s": [t[1] for t in times]}
        print(f"guard overhead, scan_chunk {chunk} (window "
              f"{ResilienceConfig().guard_window * chunk} steps): clean "
              f"epoch off {[round(t[0], 4) for t in times]} s (median "
              f"{statistics.median(t[0] for t in times):.4f}), on "
              f"{[round(t[1], 4) for t in times]} s (median "
              f"{statistics.median(t[1] for t in times):.4f}); per-pair "
              f"on/off {[round(r, 4) for r in ratios]}, median {med:.4f} "
              f"({100 * (med - 1):+.2f} %; the reference's limit +5 %)")
    return out


def strategies_phase(exp) -> dict:
    """The execution strategies at the paper's width, k = 4 workers,
    through ``Experiment(cfg, device="cuda")`` on the host experiment's
    corpus, graph and plan: a sequential epoch and a ``sync_mesh`` epoch
    on a world-size-1 NCCL group, whose ``loss/total``, history and final
    params must be equal bit for bit; an ``async_ps`` epoch (max_staleness
    2, dropout 0, 1-worker batches) with a finite ``loss/total``, repeated
    bit for bit; then its checkpoint (the live params, AdaGrad state and
    the 4 snapshots) and a resume past it, whose final checkpoint and
    history equal the uninterrupted run's bit for bit.  Each epoch
    launches K1 and K2 once a step and no other kernel (counts at 0 just
    before, read just after, ``train_phase``) and prints its ms/step."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.core.ssl_loss import tree_leaves
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.train.engine import data_group

    base = extras_config()
    path = ("graph_reg_fwd", "graph_reg_bwd_dlogp")

    def cfg_of(strategy: str, **execution):
        dropout = 0.0 if strategy == "async_ps" else base.train.dropout
        return extras_config(
            train=dataclasses.replace(base.train, n_workers=4,
                                      dropout=dropout),
            execution=dataclasses.replace(base.execution, strategy=strategy,
                                          max_staleness=2, **execution))

    def epoch(strategy: str, label: str) -> dict:
        e = Experiment(cfg_of(strategy), corpus=exp.corpus,
                       eval_data=exp.eval_data, graph=exp.graph,
                       plan=exp.plan, device="cuda").build()
        return train_phase(e, path, label)

    def rows(history):
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in history]

    def same(a, b) -> bool:
        return all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    group = data_group(4, "cuda")
    print(f"sync_mesh group: {type(group).__name__}, world size "
          f"{group.size()}, rank {group.rank()}; NCCL {nccl}")
    seq = epoch("sequential", "sequential k=4")
    mesh = epoch("sync_mesh", "sync_mesh k=4 (R=1, NCCL)")
    equal = (same(seq["params"], mesh["params"])
             and seq["row"]["loss/total"] == mesh["row"]["loss/total"]
             and rows([seq["row"]]) == rows([mesh["row"]]))
    print(f"sync_mesh vs sequential at k=4: loss/total "
          f"{mesh['row']['loss/total']!r} vs {seq['row']['loss/total']!r}, "
          f"params and history bit-equal {equal}; {mesh['steady_ms']:.3f} "
          f"vs {seq['steady_ms']:.3f} ms/step")
    check(equal, "sync_mesh at world size 1 is not the sequential run bit "
          "for bit")
    check(seq["steps"] == mesh["steps"], "the two epochs ran other steps")

    run1 = epoch("async_ps", "async_ps k=4")
    run2 = epoch("async_ps", "async_ps k=4, repeat")
    check(np.isfinite(run1["row"]["loss/total"]),
          "non-finite loss/total on the async_ps path")
    repeat = (same(run1["params"], run2["params"])
              and rows([run1["row"]]) == rows([run2["row"]]))
    print(f"async_ps repeat bit-equal {repeat}; {run1['steps']} steps of "
          f"1-worker batches")
    check(repeat, "the async_ps epoch is not bit-reproducible")

    root = ROOT / "build" / "chip_smoke_async"
    shutil.rmtree(root, ignore_errors=True)

    def ckpt_run(n_epochs: int, name: str, resume: bool = False):
        cfg = cfg_of("async_ps", checkpoint_every=1,
                     checkpoint_dir=str(root / name), resume=resume)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, n_epochs=n_epochs))
        e = Experiment(cfg, corpus=exp.corpus, eval_data=exp.eval_data,
                       graph=exp.graph, plan=exp.plan, device="cuda")
        gr.reset_launch_counts()
        res, secs = sync_time(e.run)
        return res, gr.launch_counts(), secs

    full, _, full_s = ckpt_run(2, "full")
    ckpt_run(1, "stopped")
    resumed, res_counts, res_s = ckpt_run(2, "stopped", resume=True)
    first = root / "stopped" / "ckpt_00001.npz"
    with np.load(first) as z:
        keys = [key for key in z.files if not key.startswith("__dtype__")]
        n_snap = sum(key.startswith("snapshots::") for key in keys)
        ages, t = z["ages"].tolist(), int(z["t"])
    n_bytes = first.stat().st_size
    with np.load(root / "full" / "ckpt_00002.npz") as x, \
            np.load(root / "stopped" / "ckpt_00002.npz") as y:
        differ = [key for key in x.files
                  if not np.array_equal(x[key], y[key])]
    print(f"async_ps checkpoint: {n_bytes / 1e6:.1f} MB, {len(keys)} arrays "
          f"({n_snap} of the 4 snapshots), ages {ages}, t {t}; uninterrupted "
          f"2 epochs {full_s:.2f}s; resume of epoch 1 {res_s:.2f}s, "
          f"launches {res_counts}; final checkpoint arrays differing: "
          f"{differ or 'none'}; history equal "
          f"{rows(resumed.history) == rows(full.history)}")
    check(n_snap == 4 * 2 * (base.train.n_hidden + 1),
          "the async checkpoint does not hold the 4 snapshots")
    check(not differ and rows(resumed.history) == rows(full.history),
          f"the resumed async run differs: {differ}")
    check(res_counts == {name: (run1["steps"] if name in path else 0)
                         for name in res_counts},
          f"the resumed async run launched {res_counts}")
    shutil.rmtree(root)
    return {"nccl": nccl, "sequential": seq, "sync_mesh": mesh,
            "async_ps": run1, "async_ckpt_bytes": n_bytes}


def chaos_phase() -> dict:
    """The chaos driver's three phases on the card (its config is the
    reference's own: async_ps k = 3, the stream pipeline re-partitioning
    every epoch, guard, checkpoints, a fault at every site): every site
    fires, the guard's skips equal the planned poisoned batches, phase C
    (resumed past the corrupted LATEST) equals phase A bit for bit, and
    the fired coordinates of phase A are the plan's (``chaos_plan`` is
    the reference's, held to it by the CPU tests)."""
    import shutil
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.resilience.chaos import run_chaos

    root = ROOT / "build" / "chip_smoke_chaos"
    shutil.rmtree(root, ignore_errors=True)
    gr.reset_launch_counts()
    report, secs = sync_time(lambda: run_chaos(7, workdir=str(root),
                                               device="cuda"))
    counts = gr.launch_counts()
    fired = {(f["site"], f["epoch"], f["step"])
             for f in report["phases"]["uninterrupted"]["fired"]}
    planned = {(e["site"], e["epoch"], e["step"]) for e in report["plan"]}
    print(f"chaos (seed 7, {report['device']}): {secs:.2f}s, ok "
          f"{report['ok']}, all sites fired {report['all_sites_fired']}, "
          f"skips {report['phases']['uninterrupted']['skipped_total']} of "
          f"{report['planned_poisoned_batches']} planned, resume "
          f"bit-identical {report['resume_bit_identical']}, phase A fired "
          f"the plan's coordinates {fired == planned}; launches {counts} "
          f"(pairwise 'ref')")
    check(report["ok"] and report["all_sites_fired"]
          and report["skip_counts_match"] and report["resume_bit_identical"],
          f"the chaos run failed: {json.dumps(report)[:2000]}")
    check(fired == planned, f"phase A fired {sorted(fired)}, planned "
          f"{sorted(planned)}")
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "ok": report["ok"]}


#: The quickstart (``quickstart_phase``) on the card against the same run
#: on the port's CPU path (plain K1 and K2), from the same initial params,
#: corpus, eval data, graph and plan, at every epoch of the SSL run and of
#: the supervised one: |Δ loss/total| ≤ rtol·max(1, |CPU loss|) with
#: QS_FIRST_RTOL at epoch 1 and QS_RTOL later, |Δ eval/acc| ≤ QS_FIRST_ACC
#: at epoch 1 and QS_ACC later (the eval split holds 1,000 points, so one
#: point is 0.001).  AdaGrad's update is lr·g/(√G + 1e-8), ±lr at the
#: first step wherever |g| ≫ 1e-8, so a weight whose gradient lies within
#: round-off of 0 moves by ±lr either way, and the devices drift apart
#: after the first update (the port and the reference on the CPU too,
#: ``tests/test_torch_quickstart.py``).  Each limit lies
#: between the sound card's reading and a planted fault, both read in
#: every run (:data:`QS_PLANTED`); on an H100 80GB HBM3 (700 W) the sound
#: SSL run read 5.9e-6 / 0.002 at epoch 1 and at most 9.6e-4 / 0.005
#: later, the supervised run at most 2.4e-7 / 0; K2 × (1 + 1e-3) read
#: 3.1e-3 / 0.029 at epoch 1, K2 × 0 up to 0.31 / 0.151 later.
QS_FIRST_RTOL = 1e-4
QS_RTOL = 1e-2
QS_FIRST_ACC = 0.01
QS_ACC = 0.03
#: Planted faults on the card's SSL run, each a scale of K2's output
#: (``graph_reg.reg_bwd_dlogp``), and the limits each must break: K2 ×
#: (1 + 1e-3) the first epoch's, K2 × 0 (the graph's gradient dropped,
#: which trains the supervised model with the SSL loss) a later epoch's.
QS_PLANTED = (("K2 × (1 + 1e-3)", 1 + 1e-3, "first"),
              ("K2 × 0", 0.0, "later"))


@contextlib.contextmanager
def scaled_output(module, name: str, scale: float):
    """A planted fault: ``module.name`` returns its output times
    ``scale`` inside the ``with``."""
    orig = getattr(module, name)

    def planted(*args, **kwargs):
        return orig(*args, **kwargs) * scale

    # The wrapper counts its launches on the module's name for it.
    planted.launches = getattr(orig, "launches", 0)
    setattr(module, name, planted)
    try:
        yield
    finally:
        setattr(module, name, orig)


def qs_readings(history: list, want: list) -> list:
    """Per epoch: (|Δ loss/total| / max(1, |want|), |Δ eval/acc|)."""
    return [(abs(h["loss/total"] - w["loss/total"])
             / max(1.0, abs(w["loss/total"])),
             abs(h["eval/acc"] - w["eval/acc"]))
            for h, w in zip(history, want)]


def qs_breaks(readings: list, when: str) -> bool:
    """True where ``readings`` break the first epoch's limits (``when`` =
    "first") or a later epoch's ("later")."""
    if when == "first":
        loss, acc = readings[0]
        return loss > QS_FIRST_RTOL or acc > QS_FIRST_ACC
    return any(loss > QS_RTOL or acc > QS_ACC
               for loss, acc in readings[1:])


def quickstart_phase() -> dict:
    """The twin of ``examples/quickstart.py`` on the card at its defaults
    (``repro_torch.examples.quickstart``: n 4000, 16 classes, label ratio
    0.02, the 3 × 512 DNN, 10 epochs, ``pairwise="auto"``): the SSL run,
    then the supervised run (γ = κ = 0) on its corpus, eval data, graph
    and plan.  Each run's counts from 0 just before it and read just
    after: K1 and K2 once a step and no other kernel (neither package
    skips the regularizer at γ = κ = 0, whose loss/graph must be 0 at
    every epoch); every loss finite.  Then both runs on the port's CPU
    path from the same initial params (captured from ``init_dnn`` in
    both, equal bit for bit), and the card held to them by the rule of
    :data:`QS_FIRST_RTOL` to :data:`QS_ACC`: at epoch 1 |Δ loss/total| ≤
    1e-4·max(1, |loss|) and |Δ eval/acc| ≤ 0.01, at later epochs 1e-2
    and 0.03.  The planted faults of :data:`QS_PLANTED` run on the card
    and must break it.  Prints each run's accuracy by epoch, its best
    eval/acc, the SSL − supervised gap, seconds and ms/step by the host
    clock (the engine's epoch seconds over epochs 2-10, eval excluded),
    each beside the card's name and power limit."""
    import math
    import torch
    from repro_torch.api import Experiment
    from repro_torch.examples import quickstart
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    cfg, sup_cfg = quickstart.configs()
    exp, sup = quickstart.experiments(cfg, sup_cfg, "cuda")
    build_s = time.perf_counter() - t_phase
    print(f"quickstart [{CARD}]: corpus {exp.corpus.n} points, "
          f"{int(exp.corpus.label_mask.sum())} labeled, eval "
          f"{len(exp.eval_data[1])} points; graph {exp.graph.n_edges} "
          f"edges; {exp.plan.n_meta} meta-batches; built in {build_s:.1f}s")

    def experiment(c, device):
        return Experiment(c, corpus=exp.corpus, eval_data=exp.eval_data,
                          graph=exp.graph, plan=exp.plan, device=device)

    inits, init_dnn = [], trainer.init_dnn

    def recording(*args, **kwargs):
        params = init_dnn(*args, **kwargs)
        # A copy on the host: the optimizer updates the params in place.
        inits.append([t.detach().cpu().clone() for layer in params["layers"]
                      for t in (layer["w"], layer["b"])])
        return params

    trainer.init_dnn = recording
    try:
        card = {}
        for label, e in (("ssl", exp), ("supervised", sup)):
            e.build()
            e.pipeline = counted = TimedPipeline(
                e.pipeline, e.config.execution.prefetch)
            gr.reset_launch_counts()
            res = e.run()
            torch.cuda.synchronize()
            counts = gr.launch_counts()
            E = len(res.history)
            steps = counted.n
            check(E == cfg.train.n_epochs and steps % E == 0,
                  f"quickstart {label}: {E} epochs, {steps} steps")
            want = {n: steps * (n in ("graph_reg_fwd", "graph_reg_bwd_dlogp"))
                    for n in counts}
            check(counts == want, f"quickstart {label}: launches {counts}, "
                  f"not K1 and K2 once a step ({steps}) and nothing else")
            check(all(math.isfinite(h[k]) for h in res.history
                      for k in ("loss/total", "loss/supervised",
                                "loss/graph", "eval/acc")),
                  f"quickstart {label}: a non-finite loss or accuracy")
            if label == "supervised":
                check(all(h["loss/graph"] == 0.0 for h in res.history),
                      "quickstart supervised: loss/graph is not 0 at γ = κ "
                      "= 0")
            card[label] = {
                "history": res.history, "seconds": res.seconds,
                "steps": steps, "counts": counts,
                "best_acc": res.best("eval/acc"),
                "ms_per_step": 1e3 * sum(h["seconds"]
                                         for h in res.history[1:])
                / (steps - steps // E)}
        cpu = {label: experiment(c, "cpu").run()
               for label, c in (("ssl", cfg), ("supervised", sup_cfg))}
        planted = {}
        for name, scale, when in QS_PLANTED:
            with scaled_output(gr, "reg_bwd_dlogp", scale):
                planted[name] = (experiment(cfg, "cuda").run().history,
                                 when)
    finally:
        trainer.init_dnn = init_dnn
    check(len(inits) == 4 + len(QS_PLANTED) and all(
        torch.equal(a, b) for other in inits[1:]
        for a, b in zip(inits[0], other)),
        "quickstart: the runs did not start from the same params")
    out = {"build_s": build_s, "rule": {
        "first_rtol": QS_FIRST_RTOL, "rtol": QS_RTOL,
        "first_acc": QS_FIRST_ACC, "acc": QS_ACC}}
    for label, rec in card.items():
        readings = qs_readings(rec["history"], cpu[label].history)
        accs = " ".join(f"{h['eval/acc']:.3f}" for h in rec["history"])
        cpu_accs = " ".join(f"{h['eval/acc']:.3f}"
                            for h in cpu[label].history)
        print(f"quickstart {label} [{CARD}]: acc by epoch {accs} (CPU "
              f"{cpu_accs}); best eval/acc {rec['best_acc']:.3f}; loss/total "
              + ", ".join(f"{h['loss/total']:.6g}" for h in rec["history"])
              + f"; {rec['steps']} steps in {rec['seconds']:.2f}s, "
              f"{rec['ms_per_step']:.3f} ms/step (host clock, epochs 2-"
              f"{len(rec['history'])}); launches {rec['counts']}; card vs "
              f"CPU by epoch (Δloss rel, Δacc): "
              + ", ".join(f"({a:.2e}, {b:.3f})" for a, b in readings))
        check(not qs_breaks(readings, "first")
              and not qs_breaks(readings, "later"),
              f"quickstart {label}: the card is farther from the CPU than "
              f"the rule allows (epoch 1: {QS_FIRST_RTOL:g} / "
              f"{QS_FIRST_ACC:g}; later: {QS_RTOL:g} / {QS_ACC:g}): "
              f"{readings}")
        rec["readings"] = readings
        rec["cpu_best_acc"] = cpu[label].best("eval/acc")
        out[label] = {k: rec[k] for k in (
            "best_acc", "cpu_best_acc", "seconds", "ms_per_step", "steps",
            "readings")}
        out[label]["acc"] = [h["eval/acc"] for h in rec["history"]]
    for name, (history, when) in planted.items():
        readings = qs_readings(history, cpu["ssl"].history)
        print(f"quickstart planted fault {name} on the card's SSL run: card "
              f"vs CPU by epoch (Δloss rel, Δacc): "
              + ", ".join(f"({a:.2e}, {b:.3f})" for a, b in readings)
              + f"; breaks the {when} epoch's limits: "
              f"{qs_breaks(readings, when)}")
        check(qs_breaks(readings, when), f"quickstart: the planted fault "
              f"{name} keeps within the {when} epoch's limits")
        out.setdefault("planted", {})[name] = readings
    gap = card["ssl"]["best_acc"] - card["supervised"]["best_acc"]
    out["gap"] = gap
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"quickstart [{CARD}]: best eval/acc SSL "
          f"{card['ssl']['best_acc']:.3f}, supervised "
          f"{card['supervised']['best_acc']:.3f}, SSL − supervised "
          f"{gap:+.3f} (CPU {cpu['ssl'].best('eval/acc') - cpu['supervised'].best('eval/acc'):+.3f}); "
          f"phase {out['phase_s']:.1f}s")
    return out

#: K11 against its plain version on the same key tiles: float32 within the
#: reference test's atol; bfloat16 within one bf16 ulp of the output's
#: scale, |Δ| ≤ 2^-8·max|want| + 2^-7·|want| (both round p and the output
#: at the same points but sum in float32 in other orders, so a rounding
#: may fall the other way).
ATTN_F32_ATOL = 3e-5
ATTN_TOL_RULE = ("f32: |Δ| ≤ 3e-5; bf16: |Δ| ≤ 2^-8·max|want| + "
                 "2^-7·|want|")
#: Full-width serve on the card against the CPU, float32: |Δ| ≤
#: SERVE_RTOL·max|want| on logits and cache.  cuBLAS and the CPU's BLAS
#: sum the d_model- and d_ff-long products in other orders (~1e-6
#: relative each), through 2 layers and the 151,936-wide head.
SERVE_RTOL = 1e-4


#: The device-graph epoch's loss/total before K8's redesign (an NVIDIA
#: H100 80GB HBM3 at a 700.00 W power limit, two runs): K8 keeps its bits,
#: so the device graph, its plan and this loss stay the same unless the
#: card's libraries change the epoch's other sums.
DEVICE_EPOCH_LOSS = 5.892054557800293


#: The full prefill with K11 on the FMA kernel (64-key tiles, no tensor
#: cores), B 4 × T 2048, second call, on an NVIDIA H100 80GB HBM3 at a
#: 700.00 W power limit (two runs; PERF.md names them).
PREFILL_MS_FMA_ROUTE = (145.607, 145.923)


def attn_pairs(Tq: int, Tk: int) -> int:
    """(query, key) pairs of one causal head, query row t at Tk − Tq + t."""
    return Tq * (Tk - Tq + 1) + Tq * (Tq - 1) // 2


def redesign_build_report() -> dict:
    """Registers, spills and static shared memory of the redesigned
    kernels (``-Xptxas -v``); no spill is allowed."""
    import re
    import importlib
    from repro_torch.analysis.launch_audit import REDESIGNED, ptxas_entries
    rec = {}
    for wrapper, (src, kernel) in REDESIGNED.items():
        hits = [r for name, r in ptxas_entries(src)
                if re.search(rf"\d{kernel}", name)]
        check(len(hits) == 1, f"{len(hits)} compiler reports for {kernel} "
              f"in {src}.cu")
        rec[wrapper] = r = hits[0]
        check(r["spill_bytes"] == 0, f"{kernel} spills: {r}")
        if wrapper in ("graph_reg_bwd_dw", "graph_reg_bsp_dw"):
            # The runtime's occupancy at the launch's 256 threads and no
            # dynamic shared memory.
            module = importlib.import_module(f"repro_torch.kernels.{src}")
            symbol = f"{len(kernel) - 1}{kernel}"
            r["blocks_per_sm"] = module.occupancy(
                symbol, 256, 0)["resident_blocks"]
        print(f"{kernel} (-Xptxas -v): {r['registers']} registers, "
              f"{r['static_smem_bytes']} bytes of static shared memory, "
              f"{r['spill_bytes']} bytes spilled"
              + (f", {r['blocks_per_sm']} blocks an SM (256 threads)"
                 if "blocks_per_sm" in r else ""))
    check(rec["graph_reg_bsp_dw"]["blocks_per_sm"] >= 3,
          "K7 holds fewer than three blocks an SM")
    return rec


#: The kernels of the LM heads' class routes: K1's two class-split passes
#: and K2's class route.
CLASS_ROUTE_KERNELS = ("reg_bwd_dlogp_classes", "reg_fwd_class_partials",
                       "reg_fwd_class_sum")


def class_routes_build_report() -> dict:
    """Registers, spills and static shared memory of the kernels of the LM
    heads' class routes (:data:`CLASS_ROUTE_KERNELS`, ``-Xptxas -v``), by
    kernel name; no spill is allowed."""
    import re
    from repro_torch.analysis.launch_audit import ptxas_entries
    rec = {}
    for name, r in ptxas_entries("graph_reg"):
        m = re.search(r"\d(%s)E" % "|".join(CLASS_ROUTE_KERNELS), name)
        if m is None:
            continue
        check(r["spill_bytes"] == 0, f"{m.group(1)} spills: {r}")
        rec[m.group(1)] = r
        print(f"{m.group(1)} (-Xptxas -v): {r['registers']} registers, "
              f"{r['static_smem_bytes']} bytes of static shared memory, "
              f"{r['spill_bytes']} bytes spilled")
    check(sorted(rec) == sorted(CLASS_ROUTE_KERNELS),
          f"no compiler report for every class-route kernel: {sorted(rec)}")
    return rec


def pairwise_build_report() -> dict:
    """Registers, spills and static shared memory of every kernel of
    ``pairwise.cu`` (K8's three instantiations, its segment merge and the
    packing, K9 at 128- and 64-row tiles); no spill is allowed.  Keys:
    ``knn_topk`` (shared lists, k ≤ 32: the path's), ``knn_topk_shared``
    (33 ≤ k ≤ K_MAX), ``knn_topk_global``, ``rbf_affinity`` by tile
    rows."""
    import re
    from repro_torch.analysis.launch_audit import ptxas_entries
    rec = {"rbf_affinity": {}}
    knn = {("0", "1"): "knn_topk", ("0", "0"): "knn_topk_shared",
           ("1", "0"): "knn_topk_global"}
    for kernel, r in ptxas_entries("pairwise"):
        check(r["spill_bytes"] == 0, f"{kernel} spills: {r}")
        m = re.search(r"(knn_topk_kernelILb([01])ELb([01])E|rbf_affinity_"
                      r"kernelILi(\d+)E|knn_merge_segments|pack_t)", kernel)
        check(m is not None, f"an unknown kernel in pairwise.cu: {kernel}")
        if m.group(2) is not None:
            rec[knn[m.group(2), m.group(3)]] = r
        elif m.group(4) is not None:
            rec["rbf_affinity"][int(m.group(4))] = r
        print(f"{m.group(1)} (-Xptxas -v): {r['registers']} registers, "
              f"{r['static_smem_bytes']} bytes of static shared memory, "
              f"{r['spill_bytes']} bytes spilled")
    check(sorted(rec["rbf_affinity"]) == [64, 128]
          and all(name in rec for name in knn.values()),
          f"no compiler report for K8's or K9's kernels: {sorted(rec)}")
    return rec


def flash_attention_build_report() -> dict:
    """The compiler's report for the tensor-core kernels of
    ``flash_attention.cu`` (registers, shared memory, spills; no spill is
    allowed) and the count of tensor-core ``HGMMA`` instructions in the
    built library (``cuobjdump -sass``), which must not be 0."""
    import os
    import re
    from repro_torch.analysis.launch_audit import ptxas_entries
    from repro_torch.kernels import build
    rec = {}
    for kernel, r in ptxas_entries("flash_attention"):
        m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)E", kernel)
        if m is None:
            continue
        hd = int(m.group(1))
        rec[hd] = {"registers": r["registers"],
                   "spill_bytes": r["spill_bytes"]}
        check(r["spill_bytes"] == 0,
              f"the tensor-core K11 kernel (hd {hd}) spills: {r}")
    check(sorted(rec) == [64, 112, 128], f"no compiler report for the "
          f"tensor-core K11 kernels at hd 64, 112 and 128: "
          f"{build.REPORTS['flash_attention'][-2000:]}")
    lib = build.library_path("flash_attention")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    rec["hgmma"] = len(re.findall(r"\bHGMMA\.", sass))
    rec["tma_loads"] = len(re.findall(r"\bUTMALDG\b", sass))
    check(rec["hgmma"] > 0, "the built K11 library holds no HGMMA instruction")
    smem = {hd: fa_smem(hd) for hd in (64, 112, 128)}
    for hd, b in smem.items():
        rec[hd]["dynamic_smem_bytes"] = b
    print("flash_attention tensor-core kernels (-Xptxas -v): " + "; ".join(
        f"hd {hd}: {rec[hd]['registers']} registers, {smem[hd]} bytes of "
        f"dynamic shared memory, {rec[hd]['spill_bytes']} bytes spilled"
        for hd in (64, 112, 128)) + f"; {rec['hgmma']} HGMMA and "
          f"{rec['tma_loads']} UTMALDG instructions in the library")
    return rec


#: K11 at llama-3.2-vision's and jamba's head layout (both d_model 8192,
#: 64 query heads on 8 KV heads of 128): their prefill's shape, B 4 × T
#: 2048, bf16 on the tensor-core route.
LLAMA_ATTN = (4, 2048, 64, 8, 128)
#: K11 at the head layouts of the four configurations served whole by
#: ``family_serve_phase``: their prefill's shape (B 4 × T 2048, H query
#: heads on KV heads of hd), bf16 on the tensor-core route.  Groups H / KV
#: 1 (MHA at hd 64), 3 and 8.
LAYOUT_ATTN = {"qwen1.5-0.5b": (4, 2048, 16, 16, 64),
               "musicgen-large": (4, 2048, 32, 32, 64),
               "phi4-mini-3.8b": (4, 2048, 24, 8, 128),
               "yi-9b": (4, 2048, 32, 4, 128)}


def fa_smem(hd: int) -> int:
    """Dynamic shared memory of the tensor-core K11 kernel: Q and two (K,
    V) stages of 128 rows × hd rounded up to whole 64-column boxes in bf16,
    three mbarriers, 1024 bytes of alignment (``smem_bytes`` in
    flash_attention_wgmma.cuh), held to the library's launch."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    smem = 5 * 128 * (-(-hd // 64) * 64) * 2 + 64 + 1024
    check(fa.launch_smem(torch.bfloat16, hd) == smem, f"the library's "
          f"tensor-core K11 launch at hd {hd} asks for "
          f"{fa.launch_smem(torch.bfloat16, hd)} bytes, not {smem}")
    return smem


def flash_attention_phase() -> dict:
    """K11 at the serve path's prefill shape in bf16 (the path's dtype,
    tensor-core route) and f32 (FMA route), at a ragged T, with Tq < Tk,
    at llama-3.2-vision's and jamba's prefill shape (:data:`LLAMA_ATTN`,
    64 query heads on 8 KV heads) and at the prefill shapes of
    :data:`LAYOUT_ATTN` (groups 1, 3 and 8; each on the tensor-core
    route); returns the records by case (the last by arch)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, T, H, KV, hd = 4, 2048, 12, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(11)
    records = {}
    for label, Tq, Tk, H, KV, hd, dtype in (
            ("path bf16", T, T, H, KV, hd, torch.bfloat16),
            ("path f32", T, T, H, KV, hd, torch.float32),
            ("ragged bf16", 1000, 1000, H, KV, hd, torch.bfloat16),
            ("Tq<Tk bf16", 512, T, H, KV, hd, torch.bfloat16),
            ("llama/jamba bf16", T, T) + LLAMA_ATTN[2:] + (torch.bfloat16,),
            *((arch, t, t, h, kv, d, torch.bfloat16)
              for arch, (_, t, h, kv, d) in LAYOUT_ATTN.items())):
        q, k, v = (torch.randn(B, t, h, hd, generator=gen, device="cuda")
                   .to(dtype) for t, h in ((Tq, H), (Tk, KV), (Tk, KV)))
        route, bk = fa.route(dtype, hd), fa.block_k(dtype, hd)

        def kern():
            return fa.flash_attention_gqa(q, k, v, causal=True)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=True, block_k=bk)

        a, b, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        where = (f"flash_attention [{label}, {route} route, {bk}-key tiles: "
                 f"q {tuple(q.shape)}, k/v {tuple(k.shape)}]")
        check(torch.equal(a, b), f"{where}: two launches differ")
        err = (a.float() - want.float()).abs()
        if dtype == torch.float32:
            tol = torch.full_like(err, ATTN_F32_ATOL)
        else:
            w = want.float().abs()
            tol = 2.0 ** -8 * w.max() + 2.0 ** -7 * w
        over = float((err / tol).max())
        print(f"{where}: max_abs_err={float(err.max()):.3e} "
              f"err/tol={over:.3f} ({ATTN_TOL_RULE})")
        check(math.isfinite(over) and over <= 1.0,
              f"{where} disagrees with its plain version")
        rec = {"max_abs_err": float(err.max()), "tol": float(tol.max()),
               "tol_rule": ATTN_TOL_RULE, "err_over_tol": over,
               "kernel_route": route, "block_k": bk}
        if Tq == Tk:
            # The library column: SDPA on (B, H, T, hd) views of the same
            # tensors (its causal mask is the same one when Tq == Tk),
            # timed in turns with the kernel.
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            rec.update(timed(kern, plain, sdpa))
            rec["note"] = ("library_ms is torch.nn.functional.scaled_dot_"
                           "product_attention(is_causal=True, enable_gqa="
                           "True), timed only, in turns with the kernel; "
                           "max |SDPA − K11| "
                           f"{float((sdpa().transpose(1, 2) - a).abs().max())}")
        else:
            rec.update(timed(kern, plain))
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        flops = 4.0 * hd * B * H * attn_pairs(Tq, Tk)
        rec["bound"] = bound_ms(
            q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            flops, rate)
        rec["tflop_per_s"] = flops / (rec["ms"] * 1e-3) / 1e12
        rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
        print(f"{where} [{CARD}]: {rec['ms']:.4f} ms; plain "
              f"{rec['plain_ms']:.4f} ms; "
              f"SDPA {rec['library_ms']} ms (rounds {rec['rounds']}); bound "
              f"{rec['bound'][0]:.5f}"
              f" ms ({rec['bound'][1]}); {rec['tflop_per_s']:.1f} TFLOP/s, "
              f"{100 * rec['share_of_bound']:.1f} % of the bound")
        records[label] = rec
    path = records["path bf16"]
    check(path["kernel_route"] == "wgmma",
          f"the path's K11 runs the {path['kernel_route']} route")
    for arch in LAYOUT_ATTN:
        check(records[arch]["kernel_route"] == "wgmma",
              f"K11 at {arch}'s layout runs the "
              f"{records[arch]['kernel_route']} route")
    print(f"flash_attention [path bf16]: {path['ms'] / path['library_ms']:.3f}"
          f"× SDPA's time in the same call")
    return records


def serve_parity_phase() -> None:
    """qwen2-1.5b at full width, 2 layers, float32: prefill logits and cache
    and 4 greedy decode steps on the card against the CPU, from one set of
    params.  Both devices are fed the CPU's token at each step; a token may
    differ only where the CPU's top-2 logit gap is under the tolerance."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm
    from repro_torch.serve.decode import sample_tokens

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype="float32")
    B, T, steps = 2, 256, 4
    cuda = torch.device("cuda")
    params = {"cuda": serve_lm.load_model(cfg, seed=5, device=cuda)}
    params["cpu"] = to_torch(params["cuda"], "cpu")
    prompts = serve_lm.make_prompts(cfg, B, T, seed=5, device=cuda).cpu()
    logits, caches = {}, {}
    for dev in ("cuda", "cpu"):
        gr.reset_launch_counts()
        out, caches[dev] = serve_lm.prefill(params[dev], cfg,
                                            prompts.to(dev), steps)
        logits[dev] = out["logits"].cpu()
        if dev == "cuda":
            counts = gr.launch_counts()
            check(counts == {n: cfg.n_layers * (n == "flash_attention")
                             for n in counts},
                  f"serve parity prefill launched {counts}")

    def close(what, got, want):
        got, want = got.cpu().float(), want.float()
        tol = SERVE_RTOL * float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= tol, f"serve parity: {what} differs by {err} > {tol}")
        return err, tol

    worst = {"prefill logits": close("prefill logits", logits["cuda"],
                                     logits["cpu"])}
    for f in ("k", "v"):
        worst[f"cache {f}"] = close(f"cache {f}",
                                    getattr(caches["cuda"]["layers"][0], f),
                                    getattr(caches["cpu"]["layers"][0], f))
    for f in ("positions", "valid"):
        check(torch.equal(getattr(caches["cuda"]["layers"][0], f).cpu(),
                          getattr(caches["cpu"]["layers"][0], f)),
              f"serve parity: cache {f} differs")
    cur, flips = prompts[:, -1:], 0
    for s in range(steps):
        pos = torch.full((B,), T + s - 1, dtype=torch.int32)
        lg = {dev: tf.decode_step(params[dev], cfg, caches[dev], cur.to(dev),
                                  pos.to(dev))[0].cpu() for dev in logits}
        err, tol = close(f"decode step {s} logits", lg["cuda"], lg["cpu"])
        worst[f"decode step {s}"] = (err, tol)
        tc, tg = sample_tokens(lg["cpu"]), sample_tokens(lg["cuda"])
        top2 = torch.topk(lg["cpu"][:, -1], 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = (tc != tg)[:, 0]
        check(bool((gap[differ] <= tol).all()),
              f"decode step {s}: greedy tokens {tg.tolist()} on the card vs "
              f"{tc.tolist()} on the CPU away from a near tie")
        flips += int(differ.sum())
        cur = tc
    print(f"serve parity (qwen2-1.5b full width, {cfg.n_layers} layers, f32, "
          f"B={B}, T={T}, {steps} greedy steps, card vs CPU, |Δ| ≤ "
          f"{SERVE_RTOL:g}·max|want|): " + ", ".join(
              f"{k} {e:.3e} (tol {t:.3e})" for k, (e, t) in worst.items())
          + f"; {flips} greedy tokens differ (near ties only)")


#: The architecture ``serve_phase`` serves at full width and depth (the
#: others go through ``family_serve_phase``, :data:`FAMILY_CUTS`).
SERVE_ARCH = "qwen2-1.5b"


def prefill_norms(cfg) -> int:
    """K14 launches of a prefill of ``cfg``: norm1 of every layer, norm2
    of every layer with an FFN (none in the xLSTM blocks) and the final
    norm, where the config's norm is RMSNorm (LayerNorm keeps the
    composite)."""
    from repro_torch.models.config import MLSTM, SLSTM
    if cfg.norm != "rmsnorm":
        return 0
    return 1 + sum(1 + (kind not in (SLSTM, MLSTM) and cfg.d_ff > 0)
                   for kind in cfg.layer_kinds())


def serve_phase() -> dict:
    """The full model through ``serve_lm``'s functions: prefill (K11 exactly
    n_layers times, nothing else of K1-K11, K14 2·n_layers + 1 times),
    then greedy decode (no kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import norm as knorm
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm

    cfg = get_config(SERVE_ARCH)
    B, T, steps = 4, 2048, 32
    cuda = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, load_s = sync_time(
        lambda: serve_lm.load_model(cfg, seed=0, device=cuda))
    weights = torch.cuda.memory_allocated() - base
    n_params = serve_lm.param_count(params)
    check(n_params == cfg.param_count(), f"{n_params} params drawn, "
          f"param_count() says {cfg.param_count()}")
    prompts = serve_lm.make_prompts(cfg, B, T, seed=0, device=cuda)
    warm, warm_s = sync_time(lambda: serve_lm.prefill(params, cfg, prompts,
                                                      steps))
    del warm
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    knorm.reset_launch_counts()
    (out, cache), prefill_s = sync_time(
        lambda: serve_lm.prefill(params, cfg, prompts, steps))
    counts = {**gr.launch_counts(), **knorm.launch_counts()}
    check(counts == {n: cfg.n_layers * (n == "flash_attention")
                     + prefill_norms(cfg) * (n == "rms_norm")
                     for n in counts},
          f"the prefill launched {counts}, not K11 {cfg.n_layers} times, "
          f"K14 {prefill_norms(cfg)} times and nothing else")
    logits = out["logits"]
    check(tuple(logits.shape) == (B, T, cfg.vocab_size)
          and logits.dtype == torch.bfloat16, f"prefill logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    peak_prefill = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    del out, logits
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    knorm.reset_launch_counts()
    (toks, cache), decode_s = sync_time(lambda: serve_lm.decode(
        params, cfg, cache, prompts, steps, temperature=0.0))
    last, _ = tf.decode_step(params, cfg, cache, toks[:, -1:], torch.full(
        (B,), T + steps - 1, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    dcounts = {**gr.launch_counts(), **knorm.launch_counts()}
    check(not any(dcounts.values()), f"the decode launched {dcounts}")
    check(bool(torch.isfinite(last).all()), "non-finite decode logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a decoded token out of the vocabulary")
    peak_decode = torch.cuda.max_memory_allocated() - base
    rec = {"counts": counts, "prefill_ms": 1e3 * prefill_s,
           "first_prefill_ms": 1e3 * warm_s, "load_s": load_s,
           "decode_ms_per_token": 1e3 * decode_s / steps,
           "tok_per_s": B * steps / decode_s, "weights_gb": weights / 1e9,
           "peak_prefill_gb": peak_prefill / 1e9,
           "peak_decode_gb": peak_decode / 1e9}
    print(f"serve qwen2-1.5b (full width, {cfg.n_layers} layers, bf16, "
          f"{n_params / 1e9:.3f}e9 params drawn in {load_s:.2f}s): batch {B}, "
          f"prompt {T}, cache {T + steps}: prefill {rec['prefill_ms']:.3f} ms "
          f"(with K11 on the FMA kernel: {PREFILL_MS_FMA_ROUTE[0]:.3f}–"
          f"{PREFILL_MS_FMA_ROUTE[1]:.3f} ms on an H100 80GB HBM3 at 700.00 "
          f"W; first call {rec['first_prefill_ms']:.3f} ms), launches "
          f"{counts}; decode {steps} greedy steps "
          f"{rec['decode_ms_per_token']:.3f} "
          f"ms/token, {rec['tok_per_s']:.1f} tok/s, launches {dcounts}; "
          f"device memory: weights {rec['weights_gb']:.3f} GB, peak over the "
          f"prefill {rec['peak_prefill_gb']:.3f} GB, over the decode "
          f"{rec['peak_decode_gb']:.3f} GB")
    del params, cache
    return rec


#: The LM training phases (``lm_kernel_phase`` to ``swa_serve_phase``):
#: γ and κ of the example, the card-vs-CPU tolerances of the 2-layer
#: full-width cuts (losses and metrics rtol; each gradient leaf within
#: LM_GRAD_TOL of its largest |value|), the LM-head shapes (k, B, C) of K1
#: and K2 (qwen2-1.5b's V at k 1 and 2, a ragged B, the SSL heads of
#: ``family_train_phase``: mixtral's V 32000 and xlstm-125m's 50304,
#: gpt-2's V 50257, a whole number neither of 128-class slabs nor of
#: 4-class copies, that of ``launch_phase``'s ``--smoke``: B 4 over
#: every reduced config's V of 512, then the SSL heads of phi4-mini-3.8b
#: (V 200064, the widest, its last class chunk ragged), yi-9b (64000) and
#: musicgen-large (2048, near both routes' thresholds), and the V of
#: kimi-k2, llama-3.2-vision and jamba, so that every configuration's V
#: is held), and the steps of the full model.
LM_GAMMA, LM_KAPPA = 0.05, 1e-4
LM_RTOL = 1e-4
LM_GRAD_TOL = 1e-3
LM_HEAD_SHAPES = ((1, 16, 151936), (2, 16, 151936), (1, 17, 32000),
                  (1, 16, 32000), (1, 16, 50304), (1, 16, 50257),
                  (1, 4, 512), (1, 16, 200064), (1, 16, 64000),
                  (1, 16, 2048), (1, 16, 163840), (1, 16, 128256),
                  (1, 16, 65536))
LM_STEPS, LM_SUPERVISED_STEPS = 6, 2
#: The card's name and power limit (``nvidia-smi``), set by ``main`` and
#: printed beside the LM phases' numbers.
CARD = "card not queried"
#: K1 at the LM head sums C ≈ 1.5e5 float32 products a pair of rows in one
#: fixed-order chain each (the plain version's cuBLAS product sums in
#: blocks), and L is a difference of two positive sums (γ·Σ W·Hc and
#: Σ (κ + γ·deg)·H) far larger than L itself.  So both are held to the
#: float64 value within 4·√C·u·M, u = 2^-24 and M = γ·Σ W·Hc + Σ (κ +
#: γ·deg)·H, the sum of the magnitudes: the round-off of a C-term float32
#: chain grows as √C·u of the terms' magnitude (4 standard deviations).
K1_LM_RULE = ("|Δ vs float64| ≤ 4·√C·2^-24·M, M = γ·Σ W·Hc + Σ (κ + "
              "γ·deg)·H")
#: The class-split plan (every LM head) chains no term over C: each S_ij
#: is chains of chunk/groups classes, then the groups, then the chunks,
#: and pass 2 adds a few more steps (``graph_reg.class_split_chain``, n).
#: So K1 on that plan is also held to the same rule with n for C: a
#: kernel that dropped a few classes would pass √C but not √n.
K1_CS_RULE = ("|Δ vs float64| ≤ 4·√n·2^-24·M, n = the plan's longest "
              "float32 chain (graph_reg.class_split_chain), M as in "
              "K1_LM_RULE")


def compare_conditioned(name: str, got, want64, scale64, n: int,
                        rule: str = K1_LM_RULE) -> dict:
    """Hold ``got`` to the float64 value ``want64`` within 4·√n·2^-24 of
    ``scale64``: n = C is :data:`K1_LM_RULE`, n the class-split plan's
    chain :data:`K1_CS_RULE`."""
    err = float((got.double() - want64).abs().max())
    tol = 4.0 * math.sqrt(n) * 2.0 ** -24 * float(scale64.abs().max())
    rec = {"max_abs_err": err, "tol": tol, "err_over_tol": err / tol,
           "tol_rule": rule}
    print(f"{name}: |Δ vs float64| {err:.3e}, tol {tol:.3e} ({rule}, "
          f"n = {n}), err/tol {err / tol:.3g}")
    check(err <= tol, f"{name} is farther than {rule} from float64 "
          f"(err/tol {err / tol:.3g})")
    return rec


def lm_inputs(k: int, B: int, C: int, seed: int):
    """logP of (k, B, C) random logits, a symmetric dense W (an affinity
    block of B sequences, half its entries non-zero) and g = 1/B."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (2.0 * rng.standard_normal((k, B, C))).astype(np.float32)).cuda()
    W = rng.random((k, B, B)) * (rng.random((k, B, B)) < 0.5)
    W = torch.from_numpy((W + W.transpose(0, 2, 1)).astype(np.float32))
    g = torch.full((k,), 1.0 / B, dtype=torch.float32, device="cuda")
    return torch.log_softmax(logits, dim=-1).contiguous(), W.cuda(), g


def lm_kernel_phase() -> dict:
    """K1 and K2 at the LM head's shapes: held to their plain versions,
    repeated bit for bit, timed from CUDA graphs in turns with them; K1's
    plan (the class-split plan at every LM head: pass 1's blocks and
    class chunk as the library launches them, equal to
    ``graph_reg.fwd_plan``'s) and K2's (the class route at every LM head:
    class span, blocks and threads as the library launches them, equal to
    ``graph_reg.dlogp_plan``'s, no workspace) printed, K1 held to float64
    by :data:`K1_LM_RULE` and :data:`K1_CS_RULE`, each kernel's passes
    profiled (``pass_ms``), and both no slower than their plain versions
    at any of them.  The records at the path's (1, 16, 151936), each
    shape's record under ``"graph_reg_fwd"["lm_heads"]`` and
    ``"graph_reg_bwd_dlogp"["lm_heads"]``."""
    import torch
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import ref

    gc, kap = LM_GAMMA, LM_KAPPA
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    heads = {"graph_reg_fwd": {}, "graph_reg_bwd_dlogp": {}}
    for k, B, C in LM_HEAD_SHAPES:
        plan = gr.fwd_plan(k, B, C, n_sm=n_sm)
        lib_plan = gr.launch_plan("graph_reg_fwd", k, B, C)
        check(lib_plan == {key: plan[key] for key in lib_plan},
              f"K1's plan at ({k}, {B}, {C}): the library's {lib_plan}, "
              f"the mirror's {plan}")
        check(lib_plan["class_chunk"] > 0, f"K1 at the LM head ({k}, {B}, "
              f"{C}) takes the row plan")
        print(f"graph_reg_fwd plan [LM head k={k} B={B} C={C}], the "
              f"library's: class-split route, {lib_plan['blocks']} pass-1 "
              f"blocks of {lib_plan['rows_per_block']}² entries, class "
              f"chunk {lib_plan['class_chunk']}, "
              f"{lib_plan['dynamic_smem_bytes']} bytes of dynamic shared "
              f"memory; the mirror's: {plan['class_chunks']} chunks, "
              f"{plan['class_groups']} class groups a block")
        dplan = gr.dlogp_plan(k, B, C, n_sm=n_sm)
        lib_dplan = gr.launch_plan("graph_reg_bwd_dlogp", k, B, C)
        check(lib_dplan == {key: dplan[key] for key in lib_dplan},
              f"K2's plan at ({k}, {B}, {C}): the library's {lib_dplan}, "
              f"the mirror's {dplan}")
        check(lib_dplan["class_span"] > 0, f"K2 at the LM head ({k}, {B}, "
              f"{C}) takes the row route")
        check(gr._lib().graph_reg_bwd_dlogp_workspace(k, B, C) == 0,
              f"K2 at the LM head ({k}, {B}, {C}) asks for a workspace")
        print(f"graph_reg_bwd_dlogp plan [LM head k={k} B={B} C={C}], the "
              f"library's: class route, {lib_dplan['blocks']} blocks of "
              f"{lib_dplan['threads']} threads, class span "
              f"{lib_dplan['class_span']}, all {lib_dplan['rows_per_block']}"
              f" rows, {lib_dplan['dynamic_smem_bytes']} bytes of dynamic "
              f"shared memory, no workspace; the mirror's: tiles of "
              f"{dplan['tile_classes']} classes")
        logp, W, g = lm_inputs(k, B, C, seed=B + k)
        pk = torch.exp(logp)
        runs = {
            "graph_reg_fwd": (
                lambda: gr.reg_forward(logp, W, gc, kap, gc, p=pk),
                lambda: ref.reg_forward_ref(logp, W, gc, kap, gc)),
            "graph_reg_bwd_dlogp": (
                lambda: gr.reg_bwd_dlogp(logp, W, g, gc, kap, gc, p=pk),
                lambda: ref.reg_bwd_dlogp_ref(logp, W, g, gc, kap, gc)),
        }
        s_flops = 2.0 * B * B * C
        # Each input read once (logP, P = exp(logP), W, g), each output
        # written once: the wrappers are given P, as the autograd
        # Function gives it.
        bounds = {
            "graph_reg_fwd": bound_ms(4.0 * k * (2 * B * C + B * B + 1),
                                      k * (s_flops + 2.0 * B * B
                                           + 4.0 * B * C)),
            "graph_reg_bwd_dlogp": bound_ms(
                4.0 * k * (3 * B * C + B * B + 1),
                k * (2 * s_flops + B * B + 8.0 * B * C)),
        }
        lp64, W64 = logp.double(), W.double()
        for name, (kern, plain) in runs.items():
            a, b, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            label = f"{name} [LM head k={k} B={B} C={C}]"
            check(torch.equal(a, b), f"{label}: two launches on the same "
                  "inputs differ")
            if name == "graph_reg_fwd":
                want64 = ref.reg_forward_ref(lp64, W64, gc, kap, gc)
                scale64 = ref.reg_forward_ref(lp64, W64, gc, -kap, -gc)
                err = compare_conditioned(label, a, want64, scale64, C)
                n = gr.class_split_chain(B, plan)
                err["class_split"] = compare_conditioned(
                    f"{label}, its own chains", a, want64, scale64, n,
                    K1_CS_RULE)
                compare_conditioned(f"{label}, plain version", want, want64,
                                    scale64, C)
            else:
                err = compare(label, a, want)
            rec = dict(err, **timed(kern, plain),
                       bound=bounds[name], shape=(k, B, C),
                       **gr.launch_plan(name, k, B, C))
            rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
            if name == "graph_reg_fwd":
                rec["route"] = "classes" if rec["class_chunk"] else "rows"
                passes = ("reg_fwd_class_partials", "reg_fwd_class_sum")
            else:
                rec["route"] = "classes" if rec["class_span"] else "rows"
                passes = ("reg_bwd_dlogp_classes",)
            rec["pass_ms"] = pass_ms(kern, passes)
            print(f"{label} [{CARD}]: device ms a call by pass "
                  f"(torch.profiler, 20 calls): {rec['pass_ms']}")
            heads[name][f"k={k} B={B} C={C}"] = {
                key: rec[key] for key in (
                    "ms", "plain_ms", "rounds", "max_abs_err", "tol",
                    "err_over_tol", "class_split", "share_of_bound",
                    "route", "blocks", "class_chunk", "class_span",
                    "threads", "pass_ms", "dynamic_smem_bytes", "bound")
                if key in rec}
            check(rec["ms"] <= rec["plain_ms"], f"{label}: "
                  f"{rec['ms']:.5f} ms, slower than its plain version's "
                  f"{rec['plain_ms']:.5f} ms")
            print(f"{label} [{CARD}]: {rec['ms']:.5f} ms (plain version "
                  f"{rec['plain_ms']:.5f} ms, no library call), bound "
                  f"{rec['bound'][0]:.5f} ms ({rec['bound'][1]}), "
                  f"{100 * rec['share_of_bound']:.1f} % of it; "
                  f"{rec['rows_per_block']} rows a block, "
                  f"{rec['dynamic_smem_bytes']} bytes of dynamic shared "
                  f"memory")
            if (k, B, C) == LM_HEAD_SHAPES[0]:
                records[name] = rec
    for name, by_head in heads.items():
        records[name]["lm_heads"] = by_head
    return records


def lm_parity_phase() -> None:
    """qwen2-1.5b at full width, 2 layers, float32: one ``lm_loss`` forward
    and backward with the SSL term on the card (K1 and K2 once each)
    against the same call on the CPU (plain versions), from one set of
    params and the example's first batch: 8 sequences of 64 tokens, one
    SSL group of 8, W from the host graph."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.core import SSLHyper
    from repro_torch.core.ssl_loss import tree_leaves
    from repro_torch.examples import train_lm_ssl
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import lm_grads

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype="float32")
    data = train_lm_ssl.build_data(cfg.vocab_size, 64, 4)
    batch = next(train_lm_ssl.batches(data, 4, 1, "cpu"))
    hyper = SSLHyper(gamma=LM_GAMMA, kappa=LM_KAPPA, weight_decay=0.0)
    params = {"cuda": tf.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(7))}
    params["cpu"] = to_torch(params["cuda"], "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        gr.reset_launch_counts()
        out[dev] = lm_grads(params[dev],
                            {k: v.to(dev) for k, v in batch.items()},
                            cfg=cfg, hyper=hyper, pairwise="auto")
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = gr.launch_counts()
            check(counts == {n: int(n in ("graph_reg_fwd",
                                          "graph_reg_bwd_dlogp"))
                             for n in counts},
                  f"the card's lm_loss launched {counts}")
    (g_gpu, m_gpu), (g_cpu, m_cpu) = out["cuda"], out["cpu"]
    check(set(m_gpu) == set(m_cpu) and "ssl/graph" in m_cpu,
          f"lm_loss metrics {sorted(m_gpu)} / {sorted(m_cpu)}")
    worst = {}
    for key, want in m_cpu.items():
        got, want = float(m_gpu[key]), float(want)
        tol = LM_RTOL * max(1.0, abs(want))
        worst[key] = (got, want)
        check(abs(got - want) <= tol, f"lm parity: {key} {got!r} on the "
              f"card vs {want!r} on the CPU (tol {tol:g})")
    leaf_err = 0.0
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max()) / max(scale, 1e-30)
        leaf_err = max(leaf_err, err)
        check(err <= LM_GRAD_TOL, f"lm parity: a gradient leaf of shape "
              f"{tuple(b.shape)} differs by {err:.3e} of its largest |value|")
    print(f"lm parity (qwen2-1.5b full width, {cfg.n_layers} layers, f32, 8 "
          f"sequences of 64 tokens, 1 SSL group, card vs CPU): " + ", ".join(
              f"{k} {g:.7g} / {w:.7g}" for k, (g, w) in worst.items())
          + f" (rtol {LM_RTOL:g}) [{CARD}]; worst gradient leaf "
          f"{leaf_err:.3e} of its "
          f"largest |value| (≤ {LM_GRAD_TOL:g}); launches {counts}")


def lm_train_phase() -> dict:
    """qwen2-1.5b at full width and depth (bf16, weights from a seed on the
    card): ``lm_train_step`` with AdaGrad on the example's pipeline, 16
    sequences of 4,096 tokens a step, counts at 0 just before the steps
    and read just after (K1 and K2 once a step, nothing else); then
    ``lm_supervised_step``, which launches no kernel."""
    import math
    import torch
    from repro_torch.bench import LM_TRAIN, lm_train_setup
    from repro_torch.examples import train_lm_ssl
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.train.train_step import (lm_grads, lm_supervised_step,
                                              lm_train_step)

    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    run = lm_train_setup(cuda)
    setup_s = time.perf_counter() - t0
    cfg, params, opt, state = run["cfg"], run["params"], run["opt"], \
        run["state"]
    n_steps = LM_STEPS + LM_SUPERVISED_STEPS + 1
    batches = train_lm_ssl.batches(run["data"], LM_TRAIN["batch"], n_steps,
                                   cuda)
    B = 2 * LM_TRAIN["batch"]
    tokens = B * LM_TRAIN["seq_len"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    step_s, host_s, rows = [], [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        host_s.append(time.perf_counter() - t0)
        check(tuple(batch["tokens"].shape) == (B, LM_TRAIN["seq_len"]),
              f"an LM batch of {tuple(batch['tokens'].shape)}")
        (_, _, metrics), s = sync_time(lambda: lm_train_step(
            params, state, batch, cfg=cfg, hyper=run["hyper"], opt=opt,
            lr=train_lm_ssl.LR, pairwise="auto"))
        step_s.append(s)
        rows.append({k: float(v) for k, v in metrics.items()})
    counts = gr.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts == {n: LM_STEPS * (n in ("graph_reg_fwd",
                                          "graph_reg_bwd_dlogp"))
                     for n in counts},
          f"{LM_STEPS} LM steps launched {counts}, not K1 and K2 once a "
          "step and nothing else")
    for i, row in enumerate(rows):
        for key in ("loss/ce", "ssl/graph", "loss/total"):
            check(math.isfinite(row[key]), f"LM step {i}: {key} {row[key]}")
    gr.reset_launch_counts()
    sup = []
    for _ in range(LM_SUPERVISED_STEPS):
        batch = next(batches)
        (_, _, metrics), s = sync_time(lambda: lm_supervised_step(
            params, state, batch, cfg=cfg, opt=opt, lr=train_lm_ssl.LR))
        sup.append((s, {k: float(v) for k, v in metrics.items()}))
    scounts = gr.launch_counts()
    check(not any(scounts.values()),
          f"lm_supervised_step launched {scounts}")
    for s, row in sup:
        check(set(row) == {"loss/ce", "loss/moe_aux", "loss/total"}
              and all(map(math.isfinite, row.values())),
              f"a supervised LM step's metrics {row}")
    # Where a step's time goes: forward, backward and update apart,
    # between synchronisations (one more step, after the counts).
    batch = next(batches)
    (grads, _), fb_s = sync_time(lambda: lm_grads(
        params, batch, cfg=cfg, hyper=run["hyper"], pairwise="auto"))
    _, upd_s = sync_time(lambda: opt.update(grads, state, params,
                                            train_lm_ssl.LR))
    del grads
    steady = step_s[1:]
    ms = 1e3 * sum(steady) / len(steady)
    rec = {"counts": counts, "ms_per_step": ms,
           "step_ms": [1e3 * s for s in step_s],
           "tokens_per_s": tokens / (ms / 1e3),
           "peak_gb": peak / 1e9, "setup_s": setup_s,
           "host_batch_ms": [1e3 * s for s in host_s],
           "grads_ms": 1e3 * fb_s, "update_ms": 1e3 * upd_s,
           "supervised_ms": [1e3 * s for s, _ in sup], "rows": rows}
    print(f"LM training [{CARD}] (qwen2-1.5b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, V {cfg.vocab_size}, bf16, AdaGrad lr "
          f"{train_lm_ssl.LR}, γ {LM_GAMMA}, κ {LM_KAPPA}, pairwise auto; "
          f"{B} sequences × {LM_TRAIN['seq_len']} tokens a step, 1 SSL "
          f"group; host pipeline {setup_s:.1f}s): steps "
          + ", ".join(f"{1e3 * s:.1f}" for s in step_s)
          + f" ms; {ms:.3f} ms/step over steps 2-{LM_STEPS} "
          f"(synchronised host clock), {rec['tokens_per_s']:.1f} tokens/s, "
          f"peak device memory {rec['peak_gb']:.3f} GB; host batch "
          f"assembly and copy " + ", ".join(
              f"{1e3 * s:.1f}" for s in host_s) + " ms; launches "
          f"{counts}; one more step apart: lm_loss forward+backward "
          f"{rec['grads_ms']:.1f} ms, AdaGrad update {rec['update_ms']:.1f} "
          "ms")
    for i, row in enumerate(rows):
        print(f"  LM step {i}: " + ", ".join(
            f"{k} {row[k]:.6g}" for k in ("loss/ce", "ssl/graph",
                                          "ssl/supervised", "loss/total")))
    print(f"LM supervised steps: " + ", ".join(
        f"{s * 1e3:.1f} ms loss/ce {row['loss/ce']:.6g}" for s, row in sup)
        + f"; launches {scounts}")
    del params, state, run
    torch.cuda.empty_cache()
    return rec


def swa_parity_phase() -> None:
    """qwen2-1.5b at full width, 2 layers, float32, every layer ATTN_SWA
    with a window of 256: a 640-token prefill (logits and ring caches) and
    4 greedy decode steps on the card against the CPU, from one set of
    params; no K11 launch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ATTN_SWA
    from repro_torch.serve import serve_lm
    from repro_torch.serve.decode import sample_tokens

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype="float32", block_pattern=(ATTN_SWA,),
                              sliding_window=256)
    B, T, steps = 2, 640, 4
    cuda = torch.device("cuda")
    params = {"cuda": serve_lm.load_model(cfg, seed=9, device=cuda)}
    params["cpu"] = to_torch(params["cuda"], "cpu")
    prompts = serve_lm.make_prompts(cfg, B, T, seed=9, device=cuda).cpu()
    logits, caches = {}, {}
    for dev in ("cuda", "cpu"):
        gr.reset_launch_counts()
        out, caches[dev] = serve_lm.prefill(params[dev], cfg,
                                            prompts.to(dev), steps)
        logits[dev] = out["logits"].cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = gr.launch_counts()
            check(not any(counts.values()),
                  f"the windowed prefill launched {counts}")

    def close(what, got, want):
        got, want = got.cpu().float(), want.float()
        tol = SERVE_RTOL * float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= tol, f"swa parity: {what} differs by {err} > {tol}")
        return err, tol

    worst = {"prefill logits": close("prefill logits", logits["cuda"],
                                     logits["cpu"])}
    ring = caches["cuda"]["layers"][0]
    check(ring.k.shape[2] == cfg.sliding_window,
          f"a ring cache of {ring.k.shape[2]} slots")
    for f in ("k", "v"):
        worst[f"ring cache {f}"] = close(
            f"ring cache {f}", getattr(ring, f),
            getattr(caches["cpu"]["layers"][0], f))
    for f in ("positions", "valid"):
        check(torch.equal(getattr(ring, f).cpu(),
                          getattr(caches["cpu"]["layers"][0], f)),
              f"swa parity: ring cache {f} differs")
    cur, flips = prompts[:, -1:], 0
    for s in range(steps):
        pos = torch.full((B,), T + s - 1, dtype=torch.int32)
        lg = {dev: tf.decode_step(params[dev], cfg, caches[dev], cur.to(dev),
                                  pos.to(dev))[0].cpu() for dev in logits}
        err, tol = close(f"decode step {s} logits", lg["cuda"], lg["cpu"])
        worst[f"decode step {s}"] = (err, tol)
        tc, tg = sample_tokens(lg["cpu"]), sample_tokens(lg["cuda"])
        top2 = torch.topk(lg["cpu"][:, -1], 2, dim=-1).values
        differ = (tc != tg)[:, 0]
        check(bool(((top2[:, 0] - top2[:, 1])[differ] <= tol).all()),
              f"swa decode step {s}: greedy tokens differ away from a tie")
        flips += int(differ.sum())
        cur = tc
    print(f"swa parity [{CARD}] (qwen2-1.5b full width, {cfg.n_layers} "
          f"ATTN_SWA layers, window {cfg.sliding_window}, f32, B={B}, "
          f"T={T}, {steps} greedy steps, card vs CPU, |Δ| ≤ {SERVE_RTOL:g}·max|want|): "
          + ", ".join(f"{k} {e:.3e} (tol {t:.3e})"
                      for k, (e, t) in worst.items())
          + f"; {flips} greedy tokens differ (near ties only)")


def swa_serve_phase() -> dict:
    """``config_for_shape(qwen2-1.5b, long_500k)`` at full depth, bf16
    (every layer ATTN_SWA, window 8,192): batch 1, a 10,240-token prompt
    and 16 greedy decode steps through ``serve_lm``'s functions; no kernel
    of the repo (the windowed prefill runs ``chunked_attention``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES, config_for_shape
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.serve import serve_lm

    cfg = config_for_shape(get_config("qwen2-1.5b"),
                           INPUT_SHAPES["long_500k"])
    B, T, steps = 1, 10240, 16
    cuda = torch.device("cuda")
    params = serve_lm.load_model(cfg, seed=0, device=cuda)
    prompts = serve_lm.make_prompts(cfg, B, T, seed=0, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    (out, cache), prefill_s = sync_time(
        lambda: serve_lm.prefill(params, cfg, prompts, steps))
    logits = out["logits"]
    check(tuple(logits.shape) == (B, T, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"windowed prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    del out, logits
    ring = cache["layers"][0]
    check(ring.k.shape[2] == cfg.sliding_window
          and int(ring.positions.max()) == T - 1
          and int(ring.positions.min()) == T - cfg.sliding_window,
          "the ring cache does not hold the last window of positions")
    peak_prefill = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (toks, cache), decode_s = sync_time(lambda: serve_lm.decode(
        params, cfg, cache, prompts, steps, temperature=0.0))
    counts = gr.launch_counts()
    check(not any(counts.values()), f"the windowed serve launched {counts}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a decoded token out of the vocabulary")
    rec = {"prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_token": 1e3 * decode_s / steps,
           "peak_prefill_gb": peak_prefill / 1e9,
           "peak_decode_gb": torch.cuda.max_memory_allocated() / 1e9,
           "counts": counts}
    print(f"serve {cfg.name} at long_500k's config [{CARD}] (ATTN_SWA, "
          f"window {cfg.sliding_window}, {cfg.n_layers} layers, bf16): "
          f"batch {B}, prompt {T}: prefill {rec['prefill_ms']:.3f} ms (first call), "
          f"decode {steps} greedy steps {rec['decode_ms_per_token']:.3f} "
          f"ms/token; peak device memory {rec['peak_prefill_gb']:.3f} GB "
          f"over the prefill, {rec['peak_decode_gb']:.3f} GB over the "
          f"decode; launches {counts}")
    del params, cache
    torch.cuda.empty_cache()
    return rec


#: K11 at kimi-k2's head dim: its prefill's shape, B 4 × T 2048, 64 query
#: heads on 8 KV heads of 112 (7168 / 64), bf16 on the tensor-core route
#: (the tile of hd 128, columns 112-127 zero-filled by the TMA).
KIMI_ATTN = (4, 2048, 64, 8, 112)
#: Each hd-112 case's route and key tile: (label, batch, T, dtype name,
#: route, keys a tile).
HD112_CASES = (("kimi bf16", 4, 2048, "bfloat16", "wgmma", 128),
               ("ragged f32", 1, 1000, "float32", "fma", 64))


def flash_attention_hd112_phase() -> dict:
    """K11 at head dim 112: kimi's prefill shape in bf16 (the path's, on
    the tensor-core route's 128-key tiles) and a ragged f32 case (the FMA
    route's 64-key tiles), each held to its plain version on its route's
    tiles and repeated bit for bit; the path's case timed in turns beside
    its plain version and ``scaled_dot_product_attention``, with its bound
    (its share of the bound and its factor over SDPA printed).  Returns
    the path case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, T, H, KV, hd = KIMI_ATTN
    gen = torch.Generator(device="cuda").manual_seed(12)
    path = None
    for label, b, t, dtype_name, want_route, want_bk in HD112_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(b, t, h, hd, generator=gen, device="cuda")
                   .to(dtype) for h in (H, KV, KV))
        route, bk = fa.route(dtype, hd), fa.block_k(dtype, hd)
        check((route, bk) == (want_route, want_bk),
              f"hd 112 in {dtype_name} takes the {route} route on {bk}-key "
              f"tiles, not the {want_route} route on {want_bk}")

        def kern():
            return fa.flash_attention_gqa(q, k, v, causal=True)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=True, block_k=bk)

        a, b2, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        where = (f"flash_attention hd 112 [{label}, {route} route, {bk}-key "
                 f"tiles: q {tuple(q.shape)}, k/v {tuple(k.shape)}]")
        check(torch.equal(a, b2), f"{where}: two launches differ")
        err = (a.float() - want.float()).abs()
        if dtype == torch.float32:
            tol = torch.full_like(err, ATTN_F32_ATOL)
        else:
            w = want.float().abs()
            tol = 2.0 ** -8 * w.max() + 2.0 ** -7 * w
        over = float((err / tol).max())
        print(f"{where}: max_abs_err={float(err.max()):.3e} "
              f"err/tol={over:.3f} ({ATTN_TOL_RULE})")
        check(math.isfinite(over) and over <= 1.0,
              f"{where} disagrees with its plain version")
        if label != "kimi bf16":
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        rec = {"max_abs_err": float(err.max()), "tol": float(tol.max()),
               "tol_rule": ATTN_TOL_RULE, "err_over_tol": over,
               "kernel_route": route, "block_k": bk, **timed(kern, plain,
                                                             sdpa)}
        flops = 4.0 * hd * B * H * attn_pairs(T, T)
        rec["bound"] = bound_ms(
            q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            flops, BF16_FLOP_PER_S)
        rec["tflop_per_s"] = flops / (rec["ms"] * 1e-3) / 1e12
        rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
        rec["note"] = ("library_ms is torch.nn.functional.scaled_dot_"
                       "product_attention(is_causal=True, enable_gqa=True) "
                       "at hd 112, timed only, in turns with the kernel")
        print(f"{where} [{CARD}]: {rec['ms']:.4f} ms; plain "
              f"{rec['plain_ms']:.4f} ms; SDPA {rec['library_ms']:.4f} ms "
              f"(rounds {rec['rounds']}); bound {rec['bound'][0]:.5f} ms "
              f"({rec['bound'][1]}); {rec['tflop_per_s']:.1f} TFLOP/s, "
              f"{100 * rec['share_of_bound']:.2f} % of the bound; "
              f"{rec['ms'] / rec['library_ms']:.3f}× SDPA's time")
        path = rec
        del q, k, v, a, b2, want
    torch.cuda.empty_cache()
    return path


#: The five families served at full width on one card: (config fields
#: cut, the cut in words).  Depth is cut to what one H100 holds; jamba's
#: experts too (with 16, one super-block is 45.2e9 params, 90.5 GB).
FAMILY_CUTS = {
    "mixtral-8x7b": ({"n_layers": 4}, "4 of 32 layers"),
    "kimi-k2-1t-a32b": ({"n_layers": 2}, "2 of 61 layers: the dense first "
                        "block and one MoE layer (384 experts, top 8)"),
    "llama-3.2-vision-90b": ({"n_layers": 5}, "5 of 100 layers: one "
                             "super-block (4 ATTN + XATTN)"),
    "jamba-1.5-large-398b": ({"n_layers": 8, "n_experts": 4},
                             "one super-block, 8 of 72 layers; experts 16 -> "
                             "4 per MoE layer, top 2 kept"),
    "xlstm-125m": ({}, "nothing"),
    "qwen1.5-0.5b": ({}, "nothing"),
    "musicgen-large": ({}, "nothing"),
    "phi4-mini-3.8b": ({}, "nothing"),
    "yi-9b": ({}, "nothing"),
}
#: K11 launches a prefill of each cut makes: one a causal self-attention
#: layer without a window or with one that covers the 2,048-token prompt
#: (mixtral's ATTN_SWA at 4,096; xLSTM has none).
FAMILY_K11 = {"mixtral-8x7b": 4, "kimi-k2-1t-a32b": 2,
              "llama-3.2-vision-90b": 4, "jamba-1.5-large-398b": 1,
              "xlstm-125m": 0, "qwen1.5-0.5b": 24, "musicgen-large": 48,
              "phi4-mini-3.8b": 32, "yi-9b": 48}


#: K12 and K13 in :func:`moe_kernel_phase`: (label, tokens N, width d,
#: experts E, top k, skewed): the mixtral prefill cell's request (4 ×
#: 2,048 tokens of 4,096, 8 experts, top 2), the same with nine tokens in
#: ten led by expert 0, and a decode step's batch of 4.
MOE_CASES = (("prefill", 8192, 4096, 8, 2, False),
             ("prefill skewed", 8192, 4096, 8, 2, True),
             ("decode B=4", 4, 4096, 8, 2, False))


def moe_kernel_phase() -> dict:
    """K12 (``moe_dispatch``) and K13 (``moe_combine``) in bf16 at
    :data:`MOE_CASES` on card tensors: routes drawn on the card from a
    seed (the top k of random softmax probabilities, renormalised; skewed,
    nine tokens in ten lead with expert 0), every output equal bit for bit
    to the plain version's (``moe_dispatch_ref``, ``moe_combine_ref``) on
    the same tensors and to a second launch, one launch a call; each timed
    in turns with its plain version (:func:`timed`), its bound by bytes
    (``perfbench/count/moe_flops.py``: every input read once, every
    output written once); returns the records by kernel, then case."""
    import torch
    from perfbench.count import moe_flops
    from repro_torch.kernels import moe as kmoe

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(12)
    records = {name: {} for name in kmoe.WRAPPERS}
    for label, N, d, E, k, skewed in MOE_CASES:
        c = {"d_model": d, "n_experts": E, "top_k": k, "dtype": "bfloat16"}
        x = torch.randn((N, d), generator=gen, device=cuda).bfloat16()
        probs = torch.softmax(torch.randn((N, E), generator=gen,
                                          device=cuda), -1)
        top_w, ids = torch.topk(probs, k, dim=-1)
        if skewed:
            rest = torch.argsort(torch.rand((N, E - 1), generator=gen,
                                            device=cuda), -1)[:, :k - 1] + 1
            led = torch.cat([torch.zeros_like(ids[:, :1]), rest], dim=1)
            lead = torch.rand(N, generator=gen, device=cuda) < 0.9
            ids = torch.where(lead[:, None], led, ids)
        w = top_w / top_w.sum(-1, keepdim=True)
        out = torch.randn((N * k, d), generator=gen, device=cuda).bfloat16()
        kmoe.reset_launch_counts()
        got, again = (kmoe.moe_dispatch(x, ids, E) for _ in range(2))
        y, y_again = (kmoe.moe_combine(out, got[1], w) for _ in range(2))
        want = kmoe.moe_dispatch_ref(x, ids, E)
        want_y = kmoe.moe_combine_ref(out, want[1], w)
        torch.cuda.synchronize()
        where = f"moe [{label}: N {N}, d {d}, E {E}, k {k}, bf16]"
        check(kmoe.launch_counts() == {n: 2 for n in kmoe.WRAPPERS},
              f"{where}: launches {kmoe.launch_counts()}, not 2 each")
        check(all(a.dtype == b.dtype and torch.equal(a, b) and
                  torch.equal(a, r) for a, b, r in zip(got, want, again)),
              f"{where}: K12 differs from its plain version or from itself")
        check(int(got[2].sum()) == N * k and
              int(got[2][0]) == int((ids == 0).sum()),
              f"{where}: K12 counted {got[2].tolist()}")
        check(torch.equal(y, want_y) and torch.equal(y, y_again),
              f"{where}: K13 differs from its plain version or from itself")
        counts = got[2].tolist()
        for name, kern, plain, moved in (
                ("moe_dispatch", lambda: kmoe.moe_dispatch(x, ids, E),
                 lambda: kmoe.moe_dispatch_ref(x, ids, E),
                 moe_flops.dispatch_bytes(c, N)),
                ("moe_combine", lambda: kmoe.moe_combine(out, got[1], w),
                 lambda: kmoe.moe_combine_ref(out, want[1], w),
                 moe_flops.combine_bytes(c, N))):
            rec = {"max_abs_err": 0.0, "tol": 0.0, "tol_rule": "bit for bit",
                   "err_over_tol": 0.0, **timed(kern, plain),
                   "bound": bound_ms(moved, 0.0), "bytes": moved,
                   "shape": {"N": N, "d": d, "E": E, "k": k,
                             "dtype": "bfloat16"}, "expert_rows": counts}
            rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
            print(f"{name} [{label}] [{CARD}]: bit for bit with its plain "
                  f"version and with itself (rows an expert {counts}); "
                  f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms "
                  f"(rounds {rec['rounds']}); bound {rec['bound'][0]:.5f} ms "
                  f"({moved} bytes), {100 * rec['share_of_bound']:.1f} % of "
                  "it")
            records[name][label] = rec
        del x, out, got, again, want, y, y_again, want_y
    return records


#: K14 in :func:`norm_kernel_phase`: (label, rows, d) in bf16, the four
#: prefill cells' norms (4 × 2,048 or 1 × 32,768 positions of d_model);
#: then every config's width on 64 rows in bf16 and float32.
NORM_CASES = (("qwen2-1.5b prefill_2k", 8192, 1536),
              ("phi4-mini-3.8b prefill_2k", 8192, 3072),
              ("qwen2-1.5b prefill_32k", 32768, 1536),
              ("mixtral-8x7b prefill_2k", 8192, 4096))
NORM_WIDTHS = (768, 1024, 1536, 2048, 3072, 4096, 7168, 8192)
#: Inputs of one K14 timing cycle at least this many bytes, twice the
#: 50 MB L2, so each call reads its rows from device memory, as the
#: bound assumes.
NORM_COLD_BYTES = 100e6


def norm_inputs(rows: int, d: int, dtype, gen):
    """x (rows, d) in ``dtype``, each row normal at a scale of its own
    (e^N(0, 1)), and a float32 scale 1 + 0.1·N(0, 1), on the card."""
    import torch
    cuda = torch.device("cuda")
    mag = torch.exp(torch.randn((rows, 1), generator=gen, device=cuda))
    x = (torch.randn((rows, d), generator=gen, device=cuda) * mag).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    return x, scale


def cycling(fn, xs):
    """A call of ``fn`` on the next of ``xs`` each time (a CUDA graph of
    such calls holds them in turn)."""
    it = [0]

    def call():
        it[0] += 1
        return fn(xs[it[0] % len(xs)])
    return call


def norm_kernel_phase() -> dict:
    """K14 (``kernels.norm.rms_norm``) against its plain version, the
    float32 composite, on the same card tensors under ``norm.RULE``
    (readings printed: ulps, relative, the share of elements that differ,
    each one's worst error against float64), repeated bit for bit, one
    launch a call, and its launch plan the library's: at
    :data:`NORM_CASES` in bf16, each timed in turns with the composite and
    ``torch.nn.functional.rms_norm`` (a yardstick the port never calls;
    scale cast to the rows' dtype) from CUDA graphs over inputs that
    cycle through at least :data:`NORM_COLD_BYTES`, its bound by bytes
    (rows read once and written once, scale read once); then at every
    config width on 64 rows in bf16 and float32 (the rule, untimed).
    Returns the records by label."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import norm as knorm

    gen = torch.Generator(device="cuda").manual_seed(14)
    records = {}
    cases = [(label, rows, d, torch.bfloat16) for label, rows, d in
             NORM_CASES] + [(f"d {d} {dt}", 64, d, getattr(torch, dt))
                            for d in NORM_WIDTHS
                            for dt in ("bfloat16", "float32")]
    for label, rows, d, dtype in cases:
        x, scale = norm_inputs(rows, d, dtype, gen)
        knorm.reset_launch_counts()
        got, again = (knorm.rms_norm(x, scale) for _ in range(2))
        want = knorm.rms_norm_ref(x, scale)
        torch.cuda.synchronize()
        dt = str(dtype).removeprefix("torch.")
        where = f"rms_norm [{label}: rows {rows}, d {d}, {dt}]"
        check(knorm.launch_counts() == {"rms_norm": 2},
              f"{where}: launches {knorm.launch_counts()}, not 2")
        check(torch.equal(got, again), f"{where}: differs from itself")
        r = knorm.rule_readings(got, want, x, scale)
        plan = knorm.plan(rows, d, dt)
        lib_plan = knorm.launch_plan(rows, d, dt)
        check(lib_plan == {k: plan[k] for k in lib_plan},
              f"{where}: the library's plan {lib_plan}, the mirror's {plan}")
        print(f"{where} [{CARD}]: {r['ulps']:.3f} ulps, rel "
              f"{r['rel']:.3e} from the composite, {100 * r['differing']:.4f}"
              f" % of elements differ; against float64 {r['ulps_f64']:.3f} "
              f"ulps (composite {r['composite_ulps_f64']:.3f}); "
              f"{plan['warps']} warps a row, {plan['blocks']} blocks")
        check(r["ok"], f"{where} breaks the rule ({knorm.RULE}): {r}")
        rec = {"readings": r, "tol_rule": knorm.RULE, "plan": plan,
               "shape": {"rows": rows, "d": d, "dtype": dt}}
        if rows > 64:
            del got, again, want
            xs = [x] + [norm_inputs(rows, d, dtype, gen)[0] for _ in range(
                max(1, math.ceil(NORM_COLD_BYTES / x.nbytes) - 1))]
            moved = 2 * x.nbytes + scale.nbytes
            rec.update(timed(
                cycling(lambda t: knorm.rms_norm(t, scale), xs),
                cycling(lambda t: knorm.rms_norm_ref(t, scale), xs),
                cycling(lambda t: F.rms_norm(t, (d,), scale.to(dtype)), xs)),
                bound=bound_ms(moved, 0.0), bytes=moved, buffers=len(xs))
            rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
            print(f"rms_norm [{label}] [{CARD}]: {rec['ms']:.5f} ms, plain "
                  f"{rec['plain_ms']:.5f} ms, F.rms_norm "
                  f"{rec['library_ms']:.5f} ms (rounds {rec['rounds']}, "
                  f"inputs cycled over {len(xs)} buffers); bound "
                  f"{rec['bound'][0]:.5f} ms ({moved} bytes), "
                  f"{100 * rec['share_of_bound']:.1f} % of it")
            del xs
        records[label] = rec
        del x, scale
    return records


@contextlib.contextmanager
def recorded_routes():
    """Records the experts (G, A) and capacity keep mask (G, A) of every
    capacity-path MoE call made inside the ``with``, by wrapping
    ``moe.slots`` (on their device, no host sync); yields the list."""
    from repro_torch.models.layers import moe
    routes, slots = [], moe.slots

    def recording(top_e, n_experts, cap):
        out = slots(top_e, n_experts, cap)
        routes.append((top_e, out[1]))
        return out

    moe.slots = recording
    try:
        yield routes
    finally:
        moe.slots = slots


def prefill_routes(out) -> list:
    """A prefill's MoE routing as its output records it (``out["moe"]``,
    one record a layer): (experts (N, k), assignments each expert
    computed (E,)), on their device."""
    return [(r["experts"], r["rows"]) for r in out.get("moe", ())]


def dropped_share(routes) -> float | None:
    """Share of the recorded assignments that no expert computed: each
    route pairs the experts with what was kept, a keep mask
    (:func:`recorded_routes`) or the rows an expert (:func:`prefill_routes`),
    whose sum is the assignments computed either way."""
    if not routes:
        return None
    computed = sum(int(kept.sum()) for _, kept in routes)
    return 1.0 - computed / sum(e.numel() for e, _ in routes)


def family_serve_phase(arch: str) -> dict:
    """One family at full width through ``serve_lm``'s functions (bf16,
    weights and, for the VLM, (4, 1601, 1280) modality embeddings from a
    seed on the card): batch 4, prompt 2048, cache 2080, a warm-up prefill
    (xLSTM's at a 128-token prompt), then the timed one with the counts at
    0 just before (K11 :data:`FAMILY_K11` times and nothing else of
    K1-K11; K12 and K13 once a MoE layer), 32 greedy decode steps (none
    of K1-K11; K12 and K13 once a MoE layer a step); logits finite; MoE
    drop shares printed (dropless: 0); K14 :func:`prefill_norms` times in
    the prefill, never in the decode."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import moe as kmoe
    from repro_torch.kernels import norm as knorm
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ATTN, ATTN_SWA
    from repro_torch.serve import serve_lm

    over, cut = FAMILY_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), **over)
    B, T, steps = 4, 2048, 32
    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, load_s = sync_time(
        lambda: serve_lm.load_model(cfg, seed=0, device=cuda))
    weights = torch.cuda.memory_allocated() - base
    n_params = serve_lm.param_count(params)
    prompts = serve_lm.make_prompts(cfg, B, T, seed=0, device=cuda)
    modality = serve_lm.make_modality(cfg, B, seed=0, device=cuda)
    warm_T = 128 if arch == "xlstm-125m" else T
    warm, warm_s = sync_time(lambda: serve_lm.prefill(
        params, cfg, prompts[:, :warm_T], steps, modality))
    del warm
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    kmoe.reset_launch_counts()
    knorm.reset_launch_counts()
    with recorded_routes() as capacity:
        (out, cache), prefill_s = sync_time(
            lambda: serve_lm.prefill(params, cfg, prompts, steps, modality))
    counts, moe_counts = gr.launch_counts(), kmoe.launch_counts()
    norm_launches = knorm.launch_counts()["rms_norm"]
    check(norm_launches == prefill_norms(cfg),
          f"{arch}: the prefill launched K14 {norm_launches} times, not "
          f"{prefill_norms(cfg)}")
    routes = prefill_routes(out)
    n_moe = len(routes)
    check(not capacity and moe_counts == {n: n_moe for n in kmoe.WRAPPERS},
          f"{arch}: the prefill launched {moe_counts} of K12 and K13, not "
          f"{n_moe} each, and dispatched {len(capacity)} MoE calls by "
          "capacity")
    k11 = sum(kind == ATTN or (kind == ATTN_SWA and cfg.sliding_window >= T)
              for kind in cfg.layer_kinds())
    check(k11 == FAMILY_K11[arch], f"{arch}: {k11} causal layers")
    check(counts == {n: k11 * (n == "flash_attention") for n in counts},
          f"{arch}: the prefill launched {counts}, not K11 {k11} times and "
          "nothing else")
    logits = out["logits"]
    check(tuple(logits.shape) == (B, T, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits {tuple(logits.shape)} {logits.dtype}, "
          f"finite {bool(torch.isfinite(logits).all())}")
    prefill_drop = dropped_share(routes)
    check(cfg.is_moe == (prefill_drop is not None),
          f"{arch}: {len(routes)} MoE calls in the prefill")
    peak_prefill = torch.cuda.max_memory_allocated() - base
    del out, logits, routes
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    kmoe.reset_launch_counts()
    knorm.reset_launch_counts()
    with recorded_routes() as capacity:
        (toks, cache), decode_s = sync_time(lambda: serve_lm.decode(
            params, cfg, cache, prompts, steps, temperature=0.0))
    check(knorm.launch_counts()["rms_norm"] == 0,
          f"{arch}: the decode launched K14")
    # Every decode assignment is computed: K12 and K13 run once a MoE
    # layer a step, and nothing goes through the capacity path.
    check(not capacity and kmoe.launch_counts() == {
        n: steps * n_moe for n in kmoe.WRAPPERS},
          f"{arch}: the decode launched {kmoe.launch_counts()} of K12 and "
          f"K13, not {steps * n_moe} each, and dispatched {len(capacity)} "
          "MoE calls by capacity")
    decode_drop = 0.0 if n_moe else None
    last, _ = tf.decode_step(params, cfg, cache, toks[:, -1:], torch.full(
        (B,), T + steps - 1, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    dcounts = gr.launch_counts()
    check(not any(dcounts.values()), f"{arch}: the decode launched {dcounts}")
    check(bool(torch.isfinite(last).all()), f"{arch}: non-finite decode "
          "logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{arch}: a decoded token out of the vocabulary")
    rec = {"cut": cut, "n_layers": cfg.n_layers, "params": n_params,
           "weights_gb": weights / 1e9, "load_s": load_s,
           "first_prefill_ms": 1e3 * warm_s, "warm_prompt": warm_T,
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_token": 1e3 * decode_s / steps,
           "tok_per_s": B * steps / decode_s,
           "peak_prefill_gb": peak_prefill / 1e9,
           "peak_decode_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "k11_launches": counts["flash_attention"],
           "moe_launches": moe_counts, "norm_launches": norm_launches,
           "prefill_dropped": prefill_drop, "decode_dropped": decode_drop}
    del params, cache, prompts, modality
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    drops = ("" if prefill_drop is None else
             f"; assignments dropped: prefill "
             f"{100 * prefill_drop:.3f} %, decode {100 * decode_drop:.3f} %")
    print(f"serve {arch} [{CARD}] (full width, cut: {cut}; "
          f"{cfg.n_layers} layers, bf16, {n_params / 1e9:.3f}e9 params in "
          f"the tree, {rec['weights_gb']:.3f} GB, drawn in {load_s:.2f}s): "
          f"batch {B}, prompt {T}, cache {T + steps}: prefill "
          f"{rec['prefill_ms']:.3f} ms (first call {rec['first_prefill_ms']:.3f}"
          f" ms at a {warm_T}-token prompt), K11 launches "
          f"{rec['k11_launches']}; decode {steps} greedy steps "
          f"{rec['decode_ms_per_token']:.3f} ms/token, "
          f"{rec['tok_per_s']:.1f} tok/s; peak device memory "
          f"{rec['peak_prefill_gb']:.3f} GB over the prefill, "
          f"{rec['peak_decode_gb']:.3f} GB over the decode{drops}; "
          f"logits finite; phase {rec['phase_s']:.1f}s")
    return rec


def family_parity_phase() -> None:
    """The five families' ``reduced()`` configs in f32 (XATTN gates set to
    0.5; at their init value 0 the cross-attention adds nothing): a prefill
    of 2 × 64 tokens and 4 greedy decode steps on the CPU, then twice on
    the card from the same params, fed the CPU's tokens; logits within
    atol 1e-4 of the CPU's and every cache or state leaf within 1e-4 of
    max(1, its largest |value|), MoE experts equal at every call with the
    prefill's rows an expert (its dropless records) and the decode's
    capacity keep masks, and the two card runs equal bit for bit.  Prints the
    worst logits step and the worst state leaf by name, with its |Δ| and
    largest |value|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import leaf_paths, to_torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import serve_lm
    from repro_torch.serve.decode import sample_tokens

    B, T, steps, atol = 2, 64, 4, 1e-4
    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    for arch in FAMILY_CUTS:
        cfg = get_config(arch).reduced()
        params = {"cuda": serve_lm.load_model(cfg, seed=13, device=cuda)}
        for layer in params["cuda"]["superblocks"]:
            if "gate" in layer.get("attn", {}):
                layer["attn"]["gate"].fill_(0.5)
        params["cpu"] = to_torch(params["cuda"], "cpu")
        prompts = serve_lm.make_prompts(cfg, B, T, seed=13, device=cuda)
        mem = serve_lm.make_modality(cfg, B, seed=13, device=cuda)
        feed = []                       # the CPU's greedy tokens

        def run(dev: str) -> dict:
            out, cache = serve_lm.prefill(
                params[dev], cfg, prompts.to(dev), steps,
                None if mem is None else mem.to(dev))
            routes = prefill_routes(out)
            with recorded_routes() as decoded:
                logits, cur = [out["logits"].cpu()], prompts[:, -1:].cpu()
                for s in range(steps):
                    pos = torch.full((B,), T + s - 1, dtype=torch.int32)
                    lg, cache = tf.decode_step(params[dev], cfg, cache,
                                               cur.to(dev), pos.to(dev))
                    logits.append(lg.cpu())
                    if dev == "cpu":
                        feed.append(sample_tokens(logits[-1]))
                    cur = feed[s]
            names = ["prefill logits"] + [f"decode step {s} logits"
                                          for s in range(steps)]
            states = leaf_paths(cache)
            return {"names": names + [p for p, _ in states],
                    "out": logits + [t.cpu() for _, t in states],
                    "routes": [(e.cpu(), k.cpu())
                               for e, k in routes + decoded]}

        cpu, gpu, again = run("cpu"), run("cuda"), run("cuda")
        check(gpu["names"] == cpu["names"], f"{arch}: the card's cache "
              "tree differs from the CPU's")
        worst = {"logits": (0.0, "", 0.0, 0.0), "states": (0.0, "", 0.0, 0.0)}
        abs_state = (0.0, "", 0.0)      # the state leaf of largest |Δ|
        for i, (name, a, b) in enumerate(zip(cpu["names"], gpu["out"],
                                             cpu["out"])):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{arch} parity: {name} {tuple(a.shape)} {a.dtype} vs "
                  f"{tuple(b.shape)} {b.dtype}")
            if not a.numel():
                continue
            # Logits within atol; a cache or state leaf within atol of its
            # largest |value| when that passes 1: sLSTM's stabiliser m, a
            # running max of summed log gates, grows with T (243.5 at T =
            # 68 on xlstm-125m's reduced config, where the card and the
            # CPU differ by 1.45e-4, 6e-7 of it).
            kind = "logits" if i <= steps else "states"
            err = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            scale = 1.0 if kind == "logits" else max(1.0, top)
            worst[kind] = max(worst[kind], (err / scale, name, err, top))
            if kind == "states":
                abs_state = max(abs_state, (err, name, top))
            check(err <= atol * scale, f"{arch} parity: card vs CPU differ "
                  f"by {err} in {name} {tuple(a.shape)} (largest |value| "
                  f"{top})")
        check(len(gpu["routes"]) == len(cpu["routes"]),
              f"{arch}: {len(gpu['routes'])} MoE calls on the card, "
              f"{len(cpu['routes'])} on the CPU")
        for (ea, ka), (eb, kb) in zip(gpu["routes"], cpu["routes"]):
            check(torch.equal(ea, eb) and torch.equal(ka, kb),
                  f"{arch}: MoE routing differs between card and CPU")
        check(all(torch.equal(a, b) for a, b in zip(gpu["out"], again["out"]))
              and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                      for a, b in zip(gpu["routes"], again["routes"])),
              f"{arch}: two card runs differ")
        lg, st = worst["logits"], worst["states"]
        print(f"family parity {arch} [{CARD}] (reduced, f32, B={B}, T={T}, "
              f"{steps} greedy decode steps, card vs CPU): worst |Δ| "
              f"{lg[2]:.3e} over the logits ({lg[1]}; atol {atol:g}); worst "
              f"state leaf of {len(cpu['out']) - steps - 1} {st[1]}: |Δ| "
              f"{st[2]:.3e}, largest |value| {st[3]:.4g}, "
              f"{st[0]:.3e} of max(1, largest |value|) (≤ {atol:g}); "
              f"largest state |Δ| {abs_state[0]:.3e} in {abs_state[1]} "
              f"(largest |value| {abs_state[2]:.4g}); "
              f"{len(cpu['routes'])} MoE calls routed alike; two card runs "
              "equal bit for bit")
        del params
    print(f"family parity: {time.perf_counter() - t0:.1f}s")


#: LM training of six families at the example's 16 × 128 tokens a step
#: (meta-batches of 8 with a sampled neighbour): mixtral, musicgen-large,
#: phi4-mini-3.8b and yi-9b at full width, 2 layers; xlstm-125m and
#: qwen1.5-0.5b whole.
FAMILY_TRAIN = {"mixtral-8x7b": {"n_layers": 2}, "xlstm-125m": {},
                "qwen1.5-0.5b": {}, "musicgen-large": {"n_layers": 2},
                "phi4-mini-3.8b": {"n_layers": 2}, "yi-9b": {"n_layers": 2}}
FAMILY_TRAIN_STEPS, FAMILY_SEQ_LEN, FAMILY_BATCH = 2, 128, 8


def family_train_phase(arch: str) -> dict:
    """``lm_train_step`` with AdaGrad on the example's pipeline (bf16,
    weights from a seed on the card): every loss term finite, ``moe_aux``
    > 0 for an MoE config, K1 and K2 once a step on the SSL head and no
    other kernel; ms/step and peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SSLHyper
    from repro_torch.examples import train_lm_ssl
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adagrad
    from repro_torch.serve import serve_lm
    from repro_torch.train.train_step import lm_train_step

    cfg = dataclasses.replace(get_config(arch), **FAMILY_TRAIN[arch])
    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    data = train_lm_ssl.build_data(cfg.vocab_size, FAMILY_SEQ_LEN,
                                   FAMILY_BATCH)
    host_s = time.perf_counter() - t0
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    opt = adagrad()
    state = opt.init(params)
    hyper = SSLHyper(gamma=LM_GAMMA, kappa=LM_KAPPA, weight_decay=0.0)
    batches = train_lm_ssl.batches(data, FAMILY_BATCH, FAMILY_TRAIN_STEPS,
                                   cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gr.reset_launch_counts()
    rows, step_s = [], []
    for batch in batches:
        (_, _, metrics), s = sync_time(lambda: lm_train_step(
            params, state, batch, cfg=cfg, hyper=hyper, opt=opt,
            lr=train_lm_ssl.LR, pairwise="auto"))
        step_s.append(s)
        rows.append({k: float(v) for k, v in metrics.items()})
    counts = gr.launch_counts()
    check(counts == {n: FAMILY_TRAIN_STEPS * (n in ("graph_reg_fwd",
                                                    "graph_reg_bwd_dlogp"))
                     for n in counts},
          f"{arch}: {FAMILY_TRAIN_STEPS} LM steps launched {counts}, not K1 "
          "and K2 once a step and nothing else")
    for i, row in enumerate(rows):
        check(all(math.isfinite(v) for v in row.values()),
              f"{arch} LM step {i}: {row}")
        check(not cfg.is_moe or row["loss/moe_aux"] > 0,
              f"{arch} LM step {i}: moe_aux {row['loss/moe_aux']}")
    rec = {"step_ms": [1e3 * s for s in step_s], "counts": counts,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "host_pipeline_s": host_s, "rows": rows,
           "params": serve_lm.param_count(params)}
    print(f"LM training {arch} [{CARD}] ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, V {cfg.vocab_size}, bf16, {rec['params'] / 1e9:.3f}"
          f"e9 params, AdaGrad lr {train_lm_ssl.LR}, γ {LM_GAMMA}, κ "
          f"{LM_KAPPA}, pairwise auto; {2 * FAMILY_BATCH} sequences × "
          f"{FAMILY_SEQ_LEN} tokens a step; host pipeline {host_s:.1f}s): "
          f"steps " + ", ".join(f"{ms:.1f}" for ms in rec["step_ms"])
          + f" ms; peak device memory {rec['peak_gb']:.3f} GB; launches "
          f"{counts}; " + "; ".join(
              ", ".join(f"{k} {row[k]:.6g}" for k in sorted(row))
              for row in rows))
    del params, state
    torch.cuda.empty_cache()
    return rec


#: ``--smoke`` on the card against the CPU, from the same initial params
#: (drawn on the CPU, moved to the card), each step's ``loss/total`` within
#: rtol·max(1, |CPU loss|): the first step (same params) within
#: SMOKE_FIRST_RTOL, the others within SMOKE_RTOL, or SMOKE_RECURRENT_RTOL
#: for a config with Mamba or xLSTM layers.  Reduced configs in float32, 10
#: AdaGrad steps; cuBLAS and the CPU sum in different orders.  AdaGrad's
#: first update is lr·g/(|g| + ε), so a gradient at round-off level (an
#: analytically zero one, such as the sLSTM input-gate bias's) becomes a
#: step of up to lr, of either sign, and the recurrences amplify what
#: follows (``tests/test_torch_launch.py::
#: test_recurrent_smoke_amplifies_round_off``).  Each limit, between its
#: two readings: on an H100 80GB HBM3 (700 W) the sound card's largest
#: reading is 1.5e-7 at the first step, 9.1e-5 (yi-9b) later in the
#: attention families and 9.4e-3 (jamba) in the recurrent ones; planted
#: faults on the CPU (``test_smoke_loss_rules_against_planted_faults``,
#: printed with ``-s``) read above each limit: K1 × 0.9 at the first step,
#: K2 × 0 (the SSL gradient dropped) in yi-9b, K2 × 100 in xlstm-125m.
#: The later-step rules do not hold K2 (in qwen2-1.5b K2 × 0 reads below
#: SMOKE_RTOL, in xlstm-125m K2 × 0 below SMOKE_RECURRENT_RTOL: the update
#: keeps the gradient's signs, not its size): ``lm_kernel_phase`` holds K1
#: and K2 at the smoke's SSL head.
SMOKE_FIRST_RTOL = 1e-5
SMOKE_RTOL = 3e-4
SMOKE_RECURRENT_RTOL = 2.5e-2
SMOKE_STEPS = 10
#: The dry run's combinations: every architecture at train_4k on the
#: single-pod mesh under fsdp_tp, and qwen2-1.5b at every input shape on
#: both meshes under every strategy.
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _smoke_runs(archs, device: str) -> dict:
    """``python -m repro_torch.launch.train --smoke`` over ``archs`` on
    ``device``: each architecture's JSON record."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", device, "--steps", str(SMOKE_STEPS), "--arch", *archs],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"--smoke on {device} failed: "
          f"{out.stderr[-3000:]}")
    recs = [json.loads(line)["smoke"] for line in out.stdout.splitlines()
            if line.startswith('{"smoke"')]
    return {rec["arch"]: rec for rec in recs}


def launch_phase() -> dict:
    """The launcher: ``--smoke`` for every architecture on the card (one
    process; launch counts at 0 just before each engine run and read just
    after: K1 and K2 once a step, nothing else; losses finite) against
    the same runs on the CPU (:data:`SMOKE_RTOL`), ms/step and steps/s;
    then the dry run (``meta``, at full width and depth) of
    :data:`DRYRUN_SHAPES`' combinations, every record ``ok``."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh
    from repro_torch.launch.train import SMOKE_B
    from repro_torch.models.config import MAMBA, MLSTM, SLSTM

    for arch in ARCH_IDS:
        head = (1, SMOKE_B, get_config(arch).reduced().vocab_size)
        check(head in LM_HEAD_SHAPES, f"--smoke {arch}: K1 and K2 at the SSL "
              f"head {head} are not held by lm_kernel_phase")
    t0 = time.perf_counter()
    card = _smoke_runs(ARCH_IDS, "cuda")
    card_s = time.perf_counter() - t0
    cpu = _smoke_runs(ARCH_IDS, "cpu")
    worst = 0.0
    for arch in ARCH_IDS:
        check(arch in card and arch in cpu, f"--smoke {arch}: no record")
        c, h = card[arch], cpu[arch]
        check(len(c["losses"]) == SMOKE_STEPS
              and all(math.isfinite(x) for x in c["losses"]),
              f"--smoke {arch} on the card: losses {c['losses']}")
        want = {"graph_reg_fwd": SMOKE_STEPS,
                "graph_reg_bwd_dlogp": SMOKE_STEPS}
        check(c["launches"] == want, f"--smoke {arch}: launches "
              f"{c['launches']}, not K1 and K2 once a step and nothing else")
        rels = [abs(a - b) / max(1.0, abs(b))
                for a, b in zip(c["losses"], h["losses"])]
        recurrent = bool({MAMBA, SLSTM, MLSTM}
                         & set(get_config(arch).block_pattern))
        rtol = SMOKE_RECURRENT_RTOL if recurrent else SMOKE_RTOL
        rel = max(rels)
        worst = max(worst, rel)
        print(f"launch --smoke {arch} [{CARD}] ({c['config']}, "
              f"{c['params'] / 1e6:.2f}M params, {SMOKE_STEPS} steps, "
              f"scan_chunk {c['scan_chunk']}): {c['ms_per_step']:.2f} "
              f"ms/step ({1e3 / c['ms_per_step']:.2f} steps/s over the "
              f"epoch: batches, staging, the steps, one metric fetch; "
              f"{c['seconds_with_setup']:.2f}s with the params' init and "
              f"the engine's set-up), CPU {h['ms_per_step']:.2f} ms/step; "
              f"mean loss {c['mean_loss']:.6f} (CPU {h['mean_loss']:.6f}); "
              f"|Δ|/max(1,|loss|) a step " + ", ".join(
                  f"{r:.2e}" for r in rels) + f" (first ≤ "
              f"{SMOKE_FIRST_RTOL:g}, all ≤ {rtol:g}); launches "
              f"{c['launches']}")
        check(rels[0] <= SMOKE_FIRST_RTOL and rel <= rtol,
              f"--smoke {arch}: card losses {c['losses']} vs CPU "
              f"{h['losses']}")
    print(f"launch --smoke: {len(card)} architectures ok on the card in "
          f"{card_s:.1f}s (one process); worst step loss rel {worst:.3e}")

    single, multi = production_mesh(), production_mesh(multi_pod=True)
    combos = [(arch, "train_4k", single, "fsdp_tp") for arch in ARCH_IDS]
    combos += [("qwen2-1.5b", shape, mesh, strategy)
               for shape in DRYRUN_SHAPES for mesh in (single, multi)
               for strategy in ("dp", "fsdp", "fsdp_tp")]
    t0 = time.perf_counter()
    records = dryrun.run_many(combos)
    for rec in records:
        check(rec["status"] == "ok", f"dry run {rec['arch']} {rec['shape']} "
              f"{rec['mesh']} {rec['strategy']}: {rec.get('error')}\n"
              f"{rec.get('traceback', '')[-2000:]}")
        r = rec["roofline"]
        print(f"dry run {rec['arch']} {rec['shape']} {rec['mesh']} "
              f"{rec['strategy']}: trace {rec['trace_s']:.3f}s (host CPU, "
              f"meta), dominant {r['dominant']} (compute {r['compute_s']:.4g}"
              f" s, memory {r['memory_s']:.4g} s, collective "
              f"{r['collective_s']:.4g} s at the H100 SXM's rates), FLOPs/"
              f"chip {rec['flops_per_chip']:.4g}, useful "
              f"{rec['useful_flops_ratio']:.3f}, arguments/chip "
              f"{rec['argument_bytes_per_chip'] / 1e9:.3f} GB, peak/chip "
              f"(estimate) {rec['peak_live_bytes_per_chip_estimate'] / 1e9:.3f}"
              f" GB, kernel ops {rec['kernel_ops']}")
    print(f"dry run: {len(records)} records ok in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"smoke": card, "dryrun": records}


def print_step(label: str, step: dict) -> None:
    print(f"{label} step breakdown: step between CUDA events, back to back "
          f"(includes host launch gaps) {step['step_ms_events']:.3f} ms, "
          f"host batch assembly {step['host_batch_assembly_ms']:.3f} ms, "
          f"staging (pinned copy + H2D) {step['host_staging_ms']:.3f} ms")


#: C entry points of K1, K2 and K10 in a checkout from before their
#: workspaces (the partials alone for K1 and K10, no workspace for K2):
#: ``against_phase`` calls such a library through these.
LEGACY_GRAPH_REG = {"graph_reg_fwd_n_partials": ("I", "I"),
                    "graph_reg_bwd_dlogp": tuple("PPPPIIIFFFPP")}


def legacy_graph_reg_calls(lib) -> dict:
    """K1, K2 and K10 through a library of the interface before their
    workspaces: wrapper name -> fn(logp, W, g, p, gc, kappa, ge)."""
    import ctypes
    import torch
    from repro_torch.kernels import graph_reg as gr
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, args in LEGACY_GRAPH_REG.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[a] for a in args]
        fn.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(logp, W, g, p, gc, kappa, ge):
        k, B, C = logp.shape
        part = torch.empty(lib.graph_reg_fwd_n_partials(k, B),
                           device="cuda")
        out = torch.empty(k, device="cuda")
        gr._raise_on(lib.graph_reg_fwd(
            p.data_ptr(), logp.data_ptr(), W.data_ptr(), k, B, C, gc, kappa,
            ge, part.data_ptr(), out.data_ptr(), stream()), "graph_reg_fwd")
        return out

    def pairwise(logp, W, g, p, gc, kappa, ge):
        B, C = logp.shape
        part = torch.empty(lib.graph_reg_fwd_n_partials(1, B),
                           device="cuda")
        out = torch.empty((), device="cuda")
        gr._raise_on(lib.graph_reg_pairwise(
            p.data_ptr(), logp.data_ptr(), W.data_ptr(), B, C,
            part.data_ptr(), out.data_ptr(), stream()), "graph_reg_pairwise")
        return out

    def dlogp(logp, W, g, p, gc, kappa, ge):
        k, B, C = logp.shape
        out = torch.empty(k, B, C, device="cuda")
        gr._raise_on(lib.graph_reg_bwd_dlogp(
            p.data_ptr(), logp.data_ptr(), W.data_ptr(), g.data_ptr(), k, B,
            C, gc, kappa, ge, out.data_ptr(), stream()),
            "graph_reg_bwd_dlogp")
        return out

    return {"graph_reg_fwd": fwd, "graph_reg_pairwise": pairwise,
            "graph_reg_bwd_dlogp": dlogp}


#: C entry points of K4 and K6 in a checkout from before their workspaces
#: (per-strip partials for K4, no workspace for K6): ``against_phase``
#: calls such a library through these.
LEGACY_BSP = {"graph_reg_bsp_fwd_n_partials": ("I", "I"),
              "graph_reg_bsp_fwd": tuple("PPPPPPIIIIIFFFPPP"),
              "graph_reg_bsp_dlogp": tuple("PPPPPPPPIIIIIFFFPP"),
              "graph_reg_bsp_dw": tuple("PPPPIIIIFFPP")}


def legacy_bsp_calls(lib) -> dict:
    """K4, K6 and K7 through a library of the interface before K4's and
    K6's workspaces, as the wrappers call them: wrapper name -> fn(logp,
    W, bterm, rows, cols, valid, g, bt, gc, kappa, ge, p) for K4 and K6
    (K4 ignores bterm and g), fn(logp, occ, g, bt, gc, ge, p) for K7."""
    import ctypes
    import torch
    from repro_torch.kernels import graph_reg as gr
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, args in LEGACY_BSP.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[a] for a in args]
        fn.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(logp, W, bterm, rows, cols, valid, g, bt, gc, kappa, ge, p):
        k, B, C = logp.shape
        part = torch.empty(lib.graph_reg_bsp_fwd_n_partials(k, B),
                           device="cuda")
        out = torch.empty(k, device="cuda")
        gr._raise_on(lib.graph_reg_bsp_fwd(
            p.data_ptr(), logp.data_ptr(), W.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), valid.data_ptr(), k, B, C, rows.shape[-1], bt,
            gc, kappa, ge, part.data_ptr(), out.data_ptr(), stream()),
            "graph_reg_bsp_fwd")
        return out

    def dlogp(logp, W, bterm, rows, cols, valid, g, bt, gc, kappa, ge, p):
        k, B, C = logp.shape
        out = torch.empty(k, B, C, device="cuda")
        gr._raise_on(lib.graph_reg_bsp_dlogp(
            p.data_ptr(), logp.data_ptr(), W.data_ptr(), bterm.data_ptr(),
            g.data_ptr(), rows.data_ptr(), cols.data_ptr(), valid.data_ptr(),
            k, B, C, rows.shape[-1], bt, gc, kappa, ge, out.data_ptr(),
            stream()), "graph_reg_bsp_dlogp")
        return out

    def dw(logp, occ, g, bt, gc, ge, p):
        k, B, C = logp.shape
        out = torch.empty(k, B, B, device="cuda")
        gr._raise_on(lib.graph_reg_bsp_dw(
            p.data_ptr(), logp.data_ptr(), occ.data_ptr(), g.data_ptr(), k,
            B, C, bt, gc, ge, out.data_ptr(), stream()), "graph_reg_bsp_dw")
        return out

    return {"graph_reg_bsp_fwd": fwd, "graph_reg_bsp_dlogp": dlogp,
            "graph_reg_bsp_dw": dw}


#: C entry points of K8 and K9 in a checkout from before their workspaces
#: (no plan functions): ``against_phase`` calls such a library through
#: these.
LEGACY_PAIRWISE = {"knn_topk": tuple("PPPPIIIIIPPP"),
                   "rbf_affinity": tuple("PPPPIIIFPP")}


def legacy_pairwise_calls(lib) -> dict:
    """K8 and K9 through a library of the interface before their
    workspaces: ``knn_topk(x, y, k, exclude_self)`` and
    ``rbf_affinity(x, y, sigma)``, as the wrappers call them."""
    import ctypes
    import torch
    from repro_torch.kernels import graph_reg as gr
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, args in LEGACY_PAIRWISE.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[a] for a in args]
        fn.restype = ctypes.c_int

    def operands(x, y):
        nx = torch.sum(x * x, dim=1)
        return nx, nx if y is x else torch.sum(y * y, dim=1)

    def knn(x, y, k, exclude_self):
        (N, D), M = x.shape, y.shape[0]
        nx, ny = operands(x, y)
        d2 = torch.empty(N, k, device="cuda")
        idx = torch.empty(N, k, dtype=torch.int32, device="cuda")
        gr._raise_on(lib.knn_topk(
            x.data_ptr(), y.data_ptr(), nx.data_ptr(), ny.data_ptr(), N, M,
            D, k, int(exclude_self), d2.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "knn_topk")
        return d2, idx

    def rbf(x, y, sigma):
        (N, D), M = x.shape, y.shape[0]
        nx, ny = operands(x, y)
        out = torch.empty(N, M, device="cuda")
        gr._raise_on(lib.rbf_affinity(
            x.data_ptr(), y.data_ptr(), nx.data_ptr(), ny.data_ptr(), N, M,
            D, float(sigma), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rbf_affinity")
        return out

    return {"knn_topk": knn, "rbf_affinity": rbf}


def against_phase(root: Path, W_path, gamma: float, kappa: float, X,
                  rows_x, sigma: float) -> tuple:
    """The redesigned K1, K2, K3, K5, K7, K10 and K11 (at the serve
    prefill's bf16 shape) in turns with the same C entry
    points built from another checkout's sources (``--against DIR``, e.g.
    the parent commit unpacked with ``git archive``): the same wrapper and
    inputs as the kernels line's rows, each from a CUDA graph
    (``bench.graph_ms``), two rounds in turns; the two builds' outputs
    must agree bit for bit (the redesigns keep every sum's order).  K1, K2
    and K10 are also held bit for bit against the other build at k = 3, B
    = 1001, C = 100 (4-byte copies of W's rows, K1's class chunks) and at
    B = 1001, C = 200 (K2's class chunks).  K4 and K6 (redesigned on K1's
    and K2's pipelines, bits kept) likewise on the path's block and
    layout, and bits alone at six ragged shapes (k 1-3, B 33-1001, C 1-200,
    bt 32, 64, 96, 128, 160, 256, one mask of :data:`MASK_KINDS` each).
    K8 and K9 (redesigned on the distance engine, bits kept) likewise: K8
    on the corpus X at k = 10 and on its first 4,000 rows at k = 300 and
    2,000 at k = 1,000 (the global route), K9 on the path's rows
    ``rows_x`` with ``sigma``, each timed in turns, and bits alone at k =
    40 and K9's ragged 1000 × 333.  A library from before K1's and K2's
    workspaces is called through :func:`legacy_graph_reg_calls`, one from
    before K4's and K6's through :func:`legacy_bsp_calls`, one from before
    K8's and K9's through :func:`legacy_pairwise_calls`.  Returns the
    records and a runner: ``run_on_other(fn)`` calls ``fn`` with K1's and
    K2's wrappers launching the other build's kernels."""
    import ctypes
    import numpy as np
    import torch
    from repro_torch.bench import graph_ms
    from repro_torch.core.metabatch import block_layout
    from repro_torch.kernels import build
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graph_reg_bsp as bsp
    from repro_torch.kernels import pairwise, ref

    out_dir = build.build_dir() / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    modules = {"graph_reg": gr, "graph_reg_bsp": bsp, "pairwise": pairwise,
               "flash_attention": fa}

    def compile_one(src: str) -> Path:
        lib = out_dir / f"lib{src}.so"
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(root / "src" / "repro_torch" / "csrc" / f"{src}.cu")],
            capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc failed on {root}'s {src}.cu:\n"
              f"{proc.stderr}")
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        paths = dict(zip(modules, pool.map(compile_one, modules)))
    libs = {}
    for src, module in modules.items():
        lib = ctypes.CDLL(str(paths[src]))
        if src == "flash_attention":
            lib.flash_attention_fwd.argtypes = \
                fa._lib().flash_attention_fwd.argtypes
            lib.flash_attention_fwd.restype = ctypes.c_int
        elif src != "pairwise" or hasattr(lib, "knn_topk_plan"):
            for fn_name, args in module._SIGNATURES.items():
                if hasattr(lib, fn_name):   # entry points the other tree has
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(args)
                    fn.restype = ctypes.c_int
        libs[src] = lib
    legacy = ({} if hasattr(libs["graph_reg"], "graph_reg_fwd_workspace")
              else legacy_graph_reg_calls(libs["graph_reg"]))
    legacy_pw = ({} if hasattr(libs["pairwise"], "knn_topk_plan")
                 else legacy_pairwise_calls(libs["pairwise"]))
    legacy_bsp = ({} if hasattr(libs["graph_reg_bsp"],
                                "graph_reg_bsp_fwd_workspace")
                  else legacy_bsp_calls(libs["graph_reg_bsp"]))

    def swapped(fn, module, lib):
        """``fn`` with ``module``'s wrappers launching ``lib``'s kernels."""
        def run():
            own = module._lib
            module._lib = lambda: lib
            try:
                return fn()
            finally:
                module._lib = own
        return run

    # The wrappers of K1, K2 and K10 on (logp, W, g, p): this build's, and
    # the other build's.
    this_k = {
        "graph_reg_fwd": lambda logp, W, g, p: gr.reg_forward(
            logp, W, gamma, kappa, gamma, p=p),
        "graph_reg_bwd_dlogp": lambda logp, W, g, p: gr.reg_bwd_dlogp(
            logp, W, g, gamma, kappa, gamma, p=p),
        "graph_reg_pairwise": lambda logp, W, g, p: gr.reg_pairwise(
            logp[0], W[0], p=p[0]),
    }

    def other_k(name, logp, W, g, p):
        if not legacy:
            return swapped(lambda: this_k[name](logp, W, g, p), gr,
                           libs["graph_reg"])
        if name == "graph_reg_pairwise":
            logp, W, p = logp[0], W[0], p[0]
        return lambda: legacy[name](logp, W, g, p, gamma, kappa, gamma)

    def this_and_other(name, logp, W, g, p):
        return (lambda: this_k[name](logp, W, g, p),
                other_k(name, logp, W, g, p))

    B, C = W_path.shape[0], 39
    logp, W, g = kernel_inputs(B, C, W_path, seed=B)
    p = torch.exp(logp)
    logp5, W5, _ = kernel_inputs(B, C, W_path, seed=B + 1)
    p5 = torch.exp(logp5)
    lay = block_layout(W_path, LAYOUT_BT)
    crows, ccols, cvalid = (torch.from_numpy(a)[None].cuda()
                            for a in lay.arrays()[3:6])
    occ = torch.from_numpy(lay.arrays()[6])[None].cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    Bq, Tq, H, KV, hd = 4, 2048, 12, 2, 128     # the serve prefill's K11
    qkv = [torch.randn((Bq, Tq, n, hd), generator=gen, device="cuda",
                       dtype=torch.bfloat16) for n in (H, KV, KV)]
    calls = {name: this_and_other(name, logp, W, g, p) for name in this_k}
    for name, src, call in (
            ("graph_reg_bwd_dw", "graph_reg", lambda: gr.reg_bwd_dw(
                logp, g, gamma, gamma, p=p)),
            ("graph_reg_bsp_bterm", "graph_reg_bsp", lambda: bsp.bsp_bwd_bterm(
                logp5, W5, crows, ccols, cvalid, LAYOUT_BT, p=p5)),
            ("graph_reg_bsp_dw", "graph_reg_bsp", lambda: bsp.bsp_bwd_dw(
                logp5, occ, g, LAYOUT_BT, gamma, gamma, p=p5)),
            ("flash_attention", "flash_attention",
             lambda: fa.flash_attention_gqa(*qkv))):
        calls[name] = (call, swapped(call, modules[src], libs[src]))
    records = {}
    for fn_name, (call, run_other) in calls.items():
        this, other = call(), run_other()
        torch.cuda.synchronize()
        check(torch.equal(this, other), f"{fn_name}: this checkout's kernel "
              f"and {root}'s differ")
        rounds = {"ms": [], "against_ms": []}
        for _ in range(2):
            rounds["ms"].append(graph_ms(call))
            rounds["against_ms"].append(graph_ms(run_other))
        rec = {key: float(np.mean(v)) for key, v in rounds.items()}
        rec["rounds"] = rounds
        print(f"{fn_name} [path, CUDA graphs, in turns]: this checkout "
              f"{rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} ms "
              f"(rounds {rounds}); outputs equal bit for bit")
        records[fn_name] = rec
    records.update(against_redesigned(root, libs, swapped, gamma, kappa))
    # Ragged and multi-chunk shapes, bits only.
    shapes = []
    for k, Bx, Cx in ((3, 1001, 100), (1, 1001, 200)):
        logpx = random_logp(k, Bx, Cx, seed=Bx + Cx + k)
        Wx = sparse_w(k, Bx, seed=Bx + k)
        gx = torch.tensor([0.5, -2.0, 0.25][:k], device="cuda")
        px = torch.exp(logpx)
        for name in this_k:
            call, run_other = this_and_other(name, logpx, Wx, gx, px)
            this, other = call(), run_other()
            torch.cuda.synchronize()
            where = f"{name} [k={k} B={Bx} C={Cx}]"
            check(torch.equal(this, other), f"{where}: this checkout's "
                  f"kernel and {root}'s differ")
            shapes.append(where)
    print(f"K1, K2 and K10 equal {root}'s bit for bit at "
          f"{', '.join(shapes)}")
    for name in this_k:
        records[name]["bit_equal_shapes"] = [
            where for where in shapes if where.startswith(f"{name} [")]

    # K4 and K6 (redesigned on K1's and K2's pipelines, bits kept): this
    # build's wrappers, and the other build's kernels, on (logp, W, bterm,
    # layout, g, bt): timed in turns on the path's block and layout, bits
    # alone at ragged shapes, tile edges and masks.
    this_bsp = {
        "graph_reg_bsp_fwd": lambda logp, W, bterm, rows, cols, valid, g, bt,
        p: bsp.bsp_forward(logp, W, rows, cols, valid, bt, gamma, kappa,
                           gamma, p=p),
        "graph_reg_bsp_dlogp": lambda logp, W, bterm, rows, cols, valid, g,
        bt, p: bsp.bsp_bwd_dlogp(logp, W, bterm, rows, cols, valid, g, bt,
                                 gamma, kappa, gamma, p=p),
    }

    def bsp_pair(name, *args):
        call = lambda: this_bsp[name](*args)   # noqa: E731
        if legacy_bsp:
            return call, lambda: legacy_bsp[name](*args[:-1], gamma, kappa,
                                                  gamma, args[-1])
        return call, swapped(call, bsp, libs["graph_reg_bsp"])

    rows, cols, valid = (torch.from_numpy(a)[None].cuda()
                         for a in lay.arrays()[:3])
    bterm5 = bsp.bsp_bwd_bterm(logp5, W5, crows, ccols, cvalid, LAYOUT_BT,
                               p=p5)
    for name in this_bsp:
        call, run_other = bsp_pair(name, logp5, W5, bterm5, rows, cols, valid,
                                   g, LAYOUT_BT, p5)
        this, other = call(), run_other()
        torch.cuda.synchronize()
        check(torch.equal(this, other), f"{name}: this checkout's kernel "
              f"and {root}'s differ")
        rounds = {"ms": [], "against_ms": []}
        for _ in range(2):
            rounds["ms"].append(graph_ms(call))
            rounds["against_ms"].append(graph_ms(run_other))
        rec = {key: float(np.mean(v)) for key, v in rounds.items()}
        rec["rounds"] = rounds
        print(f"{name} [path, CUDA graphs, in turns]: this checkout "
              f"{rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} ms "
              f"(rounds {rounds}); outputs equal bit for bit")
        records[name] = rec
    # K7 (redesigned on K3's tile, bits kept): in turns on the path's
    # layout, then bits alone at the ragged shapes below.
    def k7_pair(logp, occ, g, bt, p):
        def call():
            return bsp.bsp_bwd_dw(logp, occ, g, bt, gamma, 0.5, p=p)
        if legacy_bsp:
            return call, lambda: legacy_bsp["graph_reg_bsp_dw"](
                logp, occ, g, bt, gamma, 0.5, p)
        return call, swapped(call, bsp, libs["graph_reg_bsp"])

    occ = torch.from_numpy(lay.arrays()[6])[None].cuda()
    call, run_other = k7_pair(logp5, occ, g, LAYOUT_BT, p5)
    this, other = call(), run_other()
    torch.cuda.synchronize()
    check(torch.equal(this, other), f"graph_reg_bsp_dw: this checkout's "
          f"kernel and {root}'s differ")
    rounds = {"ms": [], "against_ms": []}
    for _ in range(2):
        rounds["ms"].append(graph_ms(call))
        rounds["against_ms"].append(graph_ms(run_other))
    rec = {key: float(np.mean(v)) for key, v in rounds.items()}
    rec["rounds"] = rounds
    print(f"graph_reg_bsp_dw [path, CUDA graphs, in turns]: this checkout "
          f"{rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} ms "
          f"(rounds {rounds}); outputs equal bit for bit")
    records["graph_reg_bsp_dw"] = rec
    bsp_shapes = []
    for (k, Bx, Cx, bt), kind in zip(
            ((3, 1001, 100, 32), (1, 1001, 200, 96), (2, 1000, 39, 64),
             (1, 1001, 39, 256), (3, 33, 128, 128), (2, 1001, 1, 160)),
            MASK_KINDS + MASK_KINDS[:2]):
        Wx, arrays = bsp_case(k, Bx, bt, kind, seed=Bx + bt)
        logpx = random_logp(k, Bx, Cx, seed=Bx + Cx + k)
        px = torch.exp(logpx)
        gx = torch.tensor([0.5, -2.0, 0.25][:k], device="cuda")
        bx = ref.bsp_bwd_bterm_ref(logpx, Wx, *arrays[3:6], bt)
        pairs = {name: bsp_pair(name, logpx, Wx, bx, *arrays[:3], gx, bt,
                                px) for name in this_bsp}
        pairs["graph_reg_bsp_dw"] = k7_pair(logpx, arrays[6], gx, bt, px)
        for name, (call, run_other) in pairs.items():
            this, other = call(), run_other()
            torch.cuda.synchronize()
            where = f"{name} [k={k} B={Bx} C={Cx} bt={bt} {kind}]"
            check(torch.equal(this, other), f"{where}: this checkout's "
                  f"kernel and {root}'s differ")
            bsp_shapes.append(where)
    print(f"K4, K6 and K7 equal {root}'s bit for bit at "
          f"{', '.join(bsp_shapes)}")
    for name in (*this_bsp, "graph_reg_bsp_dw"):
        records[name]["bit_equal_shapes"] = [
            where for where in bsp_shapes if where.startswith(f"{name} [")]

    # K8 and K9: this build's wrappers, and the other build's kernels.
    def other_pw(name, *args):
        if legacy_pw:
            return lambda: legacy_pw[name](*args)
        this = {"knn_topk": lambda x, y, k, ex: pairwise.knn_topk(
                    x, y, k, exclude_self=ex),
                "rbf_affinity": pairwise.rbf_affinity}[name]
        return swapped(lambda: this(*args), pairwise, libs["pairwise"])

    x = torch.from_numpy(np.ascontiguousarray(X, np.float32)).cuda()
    xr = torch.from_numpy(np.ascontiguousarray(rows_x, np.float32)).cuda()
    cases = [("knn_topk", f"N={n} k={k}", (x[:n], x[:n], k, True), t)
             for n, k, t in ((len(x), 10, True), (len(x), 40, False),
                             (4000, 300, True), (2000, 1000, True))]
    cases += [("rbf_affinity", "path", (xr, xr, sigma), True),
              ("rbf_affinity", "ragged 1000 × 333",
               (x[:1000], x[:333], sigma), False)]
    pw_shapes = []
    for name, where, args, with_times in cases:
        if name == "knn_topk":
            xa, ya, k, ex = args
            call = (lambda xa=xa, k=k, ex=ex:
                    pairwise.knn_topk(xa, xa, k, exclude_self=ex))
            run_other = other_pw(name, xa, xa, k, ex)
        else:
            xa, ya, sg = args
            call = lambda xa=xa, ya=ya, sg=sg: pairwise.rbf_affinity(xa, ya,
                                                                     sg)
            run_other = other_pw(name, xa, ya, sg)
        this, other = call(), run_other()
        torch.cuda.synchronize()
        same = (torch.equal(this[0], other[0])
                and torch.equal(this[1], other[1])
                if name == "knn_topk" else torch.equal(this, other))
        check(same, f"{name} [{where}]: this checkout's kernel and "
              f"{root}'s differ")
        pw_shapes.append(f"{name} [{where}]")
        if not with_times:
            continue
        rounds = {"ms": [], "against_ms": []}
        for _ in range(2):
            rounds["ms"].append(graph_ms(call))
            rounds["against_ms"].append(graph_ms(run_other))
        rec = {key: float(np.mean(v)) for key, v in rounds.items()}
        rec["rounds"] = rounds
        print(f"{name} [{where}, CUDA graphs, in turns]: this checkout "
              f"{rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} ms "
              f"(rounds {rounds}); outputs equal bit for bit")
        if name == "knn_topk" and where != f"N={len(x)} k=10":
            records["knn_topk"].setdefault("global_route", {})[where] = rec
        else:
            records[name] = {**rec, **records.get(name, {})}
    print(f"K8 and K9 equal {root}'s bit for bit at {', '.join(pw_shapes)}")
    for name in ("knn_topk", "rbf_affinity"):
        records[name]["bit_equal_shapes"] = [
            where for where in pw_shapes if where.startswith(f"{name} [")]

    def run_on_other(fn):
        check(not legacy, f"{root}'s K1/K2 predate their workspaces: the "
              f"wrappers cannot launch them")
        return swapped(fn, gr, libs["graph_reg"])()
    return records, run_on_other


#: The least factor by which the tensor-core K11 at kimi's shape must beat
#: the FMA kernel it replaced (``--against`` its parent, in one call).
HD112_MIN_SPEEDUP = 8.0


def against_redesigned(root: Path, libs: dict, swapped, gamma: float,
                       kappa: float) -> dict:
    """The kernels redesigned for the LM heads and kimi's head dim, in
    turns with the other build's (``--against``): K1 at qwen2-1.5b's LM
    head (1, 16, 151936) on the class-split plan, both builds held to
    float64 under :data:`K1_LM_RULE`, and K11 at kimi's bf16 shape
    (:data:`KIMI_ATTN`) on the tensor-core route, both held to the plain
    version on their own route's key tiles, this build at least
    :data:`HD112_MIN_SPEEDUP`× faster where the other build still runs
    the FMA kernel it replaced (their outputs differ bit for bit):
    whether their outputs differ bit for bit is printed (the sums run in
    other orders), not checked.  Then
    K2 on its class route (:func:`against_k2_lm_heads`), whose bits are
    checked."""
    import numpy as np
    import torch
    from repro_torch.bench import graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graph_reg as gr
    from repro_torch.kernels import ref

    k, B, C = LM_HEAD_SHAPES[0]
    logp, W, _ = lm_inputs(k, B, C, seed=B + k)
    pk = torch.exp(logp)
    lp64, W64 = logp.double(), W.double()
    want64 = ref.reg_forward_ref(lp64, W64, gamma, kappa, gamma)
    scale64 = ref.reg_forward_ref(lp64, W64, gamma, -kappa, -gamma)
    Bq, T, H, KV, hd = KIMI_ATTN
    gen = torch.Generator(device="cuda").manual_seed(13)
    qkv = [torch.randn((Bq, T, n, hd), generator=gen, device="cuda",
                       dtype=torch.bfloat16) for n in (H, KV, KV)]
    cases = {
        "graph_reg_fwd [LM head]": (
            gr, "graph_reg", lambda: gr.reg_forward(logp, W, gamma, kappa,
                                                    gamma, p=pk)),
        "flash_attention_hd112": (
            fa, "flash_attention", lambda: fa.flash_attention_gqa(*qkv)),
    }
    records = {}
    for name, (module, src, call) in cases.items():
        run_other = swapped(call, module, libs[src])
        this, other = call(), run_other()
        torch.cuda.synchronize()
        if module is gr:
            errs = {who: compare_conditioned(
                f"{name} [{who}]", got, want64, scale64, C)["err_over_tol"]
                for who, got in (("this checkout", this), (str(root), other))}
        else:
            want_this = ref.flash_attention_ref(
                *qkv, causal=True, block_k=fa.block_k(torch.bfloat16, hd))
            want_other = ref.flash_attention_ref(*qkv, causal=True,
                                                 block_k=64)
            errs = {}
            for who, got, want in (("this checkout", this, want_this),
                                   (str(root), other, want_other)):
                w = want.float().abs()
                over = float(((got.float() - want.float()).abs()
                              / (2.0 ** -8 * w.max() + 2.0 ** -7 * w)).max())
                check(over <= 1.0, f"{name} [{who}] disagrees with its plain "
                      f"version (err/tol {over:.3f}, {ATTN_TOL_RULE})")
                errs[who] = over
            del want_this, want_other
        rounds = {"ms": [], "against_ms": []}
        for _ in range(2):
            rounds["ms"].append(graph_ms(call))
            rounds["against_ms"].append(graph_ms(run_other))
        rec = {key: float(np.mean(v)) for key, v in rounds.items()}
        rec.update(rounds=rounds, err_over_tol=errs,
                   bit_equal=bool(torch.equal(this, other)))
        rec["speedup"] = rec["against_ms"] / rec["ms"]
        print(f"{name} [redesigned, CUDA graphs, in turns]: this checkout "
              f"{rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} ms "
              f"({rec['speedup']:.2f}×; rounds {rounds}); outputs "
              f"{'equal' if rec['bit_equal'] else 'differ'} bit for bit "
              f"(sums in another order), err/tol {errs}")
        if module is fa and rec["bit_equal"]:
            # Equal bf16 bits: the other build runs this tensor-core
            # kernel too (a descendant of its redesign), not the FMA
            # kernel it replaced.
            print(f"{name}: {root} runs this build's kernel (outputs equal "
                  f"bit for bit); no speedup over it is asked")
        elif module is fa:
            check(rec["speedup"] >= HD112_MIN_SPEEDUP,
                  f"{name}: {rec['speedup']:.2f}× the other build's kernel, "
                  f"not the {HD112_MIN_SPEEDUP}× at least")
        records[name] = rec
    del qkv
    torch.cuda.empty_cache()
    records["graph_reg_bwd_dlogp [LM head]"] = against_k2_lm_heads(
        root, libs, swapped)
    return records


#: The least factor by which K2's class route at qwen2-1.5b's LM head must
#: beat the row route it replaced there (``--against`` its parent).
K2_LM_MIN_SPEEDUP = 5.0


def against_k2_lm_heads(root: Path, libs: dict, swapped) -> dict:
    """K2 at every LM head (:data:`LM_HEAD_SHAPES`) on this build's class
    route and on the other build's kernels (``--against``): the class
    route keeps the row route's sums, so the outputs must be equal bit for
    bit at every head; at qwen2-1.5b's (1, 16, 151936) both are timed in
    turns (``bench.graph_ms``), each build's passes profiled
    (``pass_ms``: the class kernel here, ``pad_classes`` and the cluster
    kernel in the parent), and this build must be at least
    :data:`K2_LM_MIN_SPEEDUP`× faster where the other build still runs
    the row route there (it sizes a workspace at that head)."""
    import numpy as np
    import torch
    from repro_torch.bench import graph_ms
    from repro_torch.kernels import graph_reg as gr

    gc, kap = LM_GAMMA, LM_KAPPA
    shapes, rec = [], None
    for k, B, C in LM_HEAD_SHAPES:
        logp, W, g = lm_inputs(k, B, C, seed=B + k)
        pk = torch.exp(logp)

        def call():
            return gr.reg_bwd_dlogp(logp, W, g, gc, kap, gc, p=pk)
        run_other = swapped(call, gr, libs["graph_reg"])
        this, other = call(), run_other()
        torch.cuda.synchronize()
        where = f"graph_reg_bwd_dlogp [LM head k={k} B={B} C={C}]"
        check(torch.equal(this, other), f"{where}: this checkout's kernel "
              f"and {root}'s differ")
        shapes.append(where)
        if (k, B, C) != LM_HEAD_SHAPES[0]:
            continue
        rounds = {"ms": [], "against_ms": []}
        for _ in range(2):
            rounds["ms"].append(graph_ms(call))
            rounds["against_ms"].append(graph_ms(run_other))
        rec = {key: float(np.mean(v)) for key, v in rounds.items()}
        rec.update(rounds=rounds, bit_equal=True,
                   pass_ms=pass_ms(call, ("reg_bwd_dlogp_classes",)),
                   against_pass_ms=pass_ms(run_other, ("pad_classes",
                                                       "reg_bwd_dlogp")))
        rec["speedup"] = rec["against_ms"] / rec["ms"]
        print(f"{where} [redesigned, CUDA graphs, in turns; {CARD}]: this "
              f"checkout {rec['ms']:.5f} ms, {root} {rec['against_ms']:.5f} "
              f"ms ({rec['speedup']:.2f}×; rounds {rounds}); device ms by "
              f"pass (torch.profiler, 20 calls): this checkout "
              f"{rec['pass_ms']}, {root} {rec['against_pass_ms']}; outputs "
              f"equal bit for bit")
        rec["against_route"] = (
            "rows" if libs["graph_reg"].graph_reg_bwd_dlogp_workspace(
                k, B, C) > 0 else "classes")
        if rec["against_route"] == "rows":
            check(rec["speedup"] >= K2_LM_MIN_SPEEDUP,
                  f"{where}: {rec['speedup']:.2f}× the other build's kernel, "
                  f"not the {K2_LM_MIN_SPEEDUP}× at least")
        else:
            print(f"{where}: {root} runs the class route too; no speedup "
                  f"over it is asked")
    print(f"K2 equals {root}'s bit for bit at {', '.join(shapes)}")
    rec["bit_equal_shapes"] = shapes
    return rec


def against_train_phase(exp, root: Path, dense_row: dict,
                        run_on_other) -> dict:
    """The paper's dense epoch (K1 and K2 at k 1, B = P, C 39) from a fresh
    experiment on the host graph, once on this build's kernels and once
    on the other build's (``--against``; ``run_on_other`` from
    :func:`against_phase`): both rows must equal the main path's epoch
    (``dense_row``) bit for bit, so the redesigns left the DNN engine's
    losses as they were."""
    from repro_torch.api import Experiment
    from repro_torch.bench import paper_config

    rows = {}
    for who, run in (("this checkout", lambda fn: fn()),
                     (str(root), run_on_other)):
        fresh = Experiment(paper_config(), corpus=exp.corpus,
                           eval_data=exp.eval_data, graph=exp.graph,
                           plan=exp.plan, device="cuda").build()
        rows[who] = run(lambda: train_phase(
            fresh, ("graph_reg_fwd", "graph_reg_bwd_dlogp"),
            f"dense epoch on {who}'s K1/K2")["row"])
    keys = ("loss/supervised", "loss/graph", "loss/l2", "acc/labeled",
            "loss/total", "eval/acc")
    for who, row in rows.items():
        got = {key: row.get(key) for key in keys}
        want = {key: dense_row.get(key) for key in keys}
        check(got == want, f"the dense epoch on {who}'s K1/K2: {got}, not "
              f"the main path's {want}")
    print(f"dense epoch against {root}: this checkout's and {root}'s K1/K2 "
          f"give the main path's row bit for bit "
          f"({ {key: dense_row.get(key) for key in keys} })")
    return {"row": {key: dense_row.get(key) for key in keys}}


def audit_launches() -> dict:
    """The kernels each audited entry must launch inside its boundary on
    the card: K1-K3 once in the fused entry, K4-K7 once in the
    block-sparse one, K8 once in the k-NN entries, and K1 and K2 once a
    step of every engine entry's chunk."""
    from repro_torch.analysis.entrypoints import CHUNK_STEPS
    return {
        "graph_reg_fused": {"graph_reg_fwd": 1, "graph_reg_bwd_dlogp": 1,
                            "graph_reg_bwd_dw": 1},
        "graph_reg_blocksparse": {"graph_reg_bsp_fwd": 1,
                                  "graph_reg_bsp_bterm": 1,
                                  "graph_reg_bsp_dlogp": 1,
                                  "graph_reg_bsp_dw": 1},
        "knn_topk": {"knn_topk": 1},
        "online_refresh": {"knn_topk": 1},
        **{f"engine_{s}": {"graph_reg_fwd": CHUNK_STEPS,
                           "graph_reg_bwd_dlogp": CHUNK_STEPS}
           for s in ("sequential", "sync_mesh", "async_ps", "capture")},
    }


def _sync_checked(entry) -> str | None:
    """Trace ``entry`` once with host syncs inside its chunk raising
    (``trace_entry(sync_check=True)``); the error's text, or None."""
    import torch
    from repro_torch.analysis.graph_audit import trace_entry
    try:
        trace_entry(entry, sync_check=True)
        torch.cuda.synchronize()
        return None
    except RuntimeError as e:
        return str(e).splitlines()[0]


def _outputs(result) -> list:
    from repro_torch.analysis.graph_audit import reachable_tensors
    return [t.detach().clone() for _, t in reachable_tensors(result)]


def _twice(entry, *, deterministic: bool = True
           ) -> tuple[bool, str | None]:
    """Run ``entry`` twice, each from a fresh build, with
    ``torch.use_deterministic_algorithms(deterministic)``: whether every
    output agrees bit for bit, and the error's text if the mode refused
    an op."""
    import os

    import torch
    runs = []
    if deterministic:
        # cuBLAS is deterministic only with a fixed workspace
        # configuration; PyTorch reads this when the mode first meets a
        # cuBLAS call.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(deterministic)
    try:
        for _ in range(2):
            ctx = entry.context() if entry.context \
                else contextlib.nullcontext()
            with ctx:
                fn, args = entry.build()
                runs.append(_outputs(fn(*args)))
                del fn, args
    except RuntimeError as e:
        return False, str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = runs
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b)), None


def analysis_phase() -> dict:
    """The port's analysis tooling on the card: all seven pass families
    (``build_report(device="cuda")``) held to the port's baseline, the
    kernels each entry launched inside its boundary, each engine chunk
    traced again with host syncs raising and each entry run twice under
    deterministic algorithms (held to J004 and D001), the launch models
    held to the library's plans, the compiler's report and the runtime's
    occupancy, and planted twins for the card-only checks."""
    from repro_torch.analysis import entrypoints
    # One world-1 NCCL group for the whole phase: every sync_mesh run
    # below finds it initialised and reuses it.
    entrypoints.set_device("cuda")
    with entrypoints._world_group():
        return _analysis_runs()


def _analysis_runs() -> dict:
    import dataclasses

    import torch
    from repro_torch.analysis import (cli, entrypoints, findings,
                                      graph_audit, launch_audit)
    from repro_torch.analysis.determinism_audit import \
        audit_entry_determinism
    from repro_torch.api.registry import AUDIT
    from repro_torch.kernels.boundary import boundary
    t0 = time.perf_counter()
    report = cli.build_report(root=str(ROOT), device="cuda")
    host_s = time.perf_counter() - t0
    baseline = findings.load_baseline(str(ROOT / cli.BASELINE))
    new = findings.unbaselined(report.gating, baseline)
    for line in cli._summary_lines(report):
        print(line)
    for f in new:
        print(f"NEW {f.format()}")
    check(not new, f"{len(new)} unbaselined finding(s) on the card")
    print(f"analysis [{CARD}]: build_report(device='cuda') over "
          f"{len(report.passes) - 1} pass families, {len(report.findings)} "
          f"finding(s), {len(new)} not in the baseline, {host_s:.1f} s of "
          f"host time")
    jm = report.metrics["jaxpr/entries"]
    traced = {name: {"launches": trace.launches,
                     "boundaries": sorted({op.kernel for op in trace.ops
                                           if op.kernel}),
                     "ops": len(trace.ops)}
              for name, trace in report.traces.items()}
    for name, rec in traced.items():
        print(f"analysis {name}: launches {rec['launches']}, boundaries "
              f"{rec['boundaries']}, {rec['ops']} ops, BxB outside kernels "
              f"{jm[name].get('bxb_outside_kernels', '-')}")
    for name, want in audit_launches().items():
        got = traced[name]["launches"]
        for kern, n in want.items():
            check(got.get(kern, 0) == n,
                  f"{name} launched {kern} {got.get(kern, 0)} times "
                  f"inside its boundary (want {n})")
            check(kern in traced[name]["boundaries"],
                  f"{name}: no op inside {kern}'s boundary")
    for name in ("graph_reg_fused", "graph_reg_blocksparse", "knn_topk",
                 "online_refresh", "ssl_objective"):
        check(jm[name]["bxb_outside_kernels"] == 0,
              f"{name}: {jm[name]['bxb_outside_kernels']} (B, B) outputs "
              "outside kernels on the card")
    check(jm["graph_reg_ref"]["bxb_outside_kernels"] >= 3,
          "the graph_reg_ref canary counted fewer than 3 (B, B) outputs")

    # Host syncs inside a chunk: J004 against the card's sync check.
    syncs = {}
    for name in AUDIT.names():
        if not name.startswith("engine_"):
            continue
        err = _sync_checked(AUDIT.get(name))
        j004 = jm[name]["host_syncs_in_chunk"]
        syncs[name] = {"sync_debug_error": err, "j004": j004}
        print(f"analysis {name}: chunk under set_sync_debug_mode('error'): "
              f"{'raised: ' + err if err else 'no sync'}; J004 counted "
              f"{j004}")
        check((err is None) == (j004 == 0),
              f"{name}: J004 ({j004}) and the card's sync check ({err}) "
              "disagree")
    # Bit reproducibility: D001 against deterministic algorithms.
    det = {}
    dm = report.metrics["determinism/entries"]
    d001 = {f.where for f in report.findings if f.rule == "D001"}
    for name in AUDIT.names():
        entry = AUDIT.get(name)
        if not entry.deterministic:
            continue
        same, err = _twice(entry)
        det[name] = {"bitwise": same, "refused": err,
                     "scatters_checked": dm[name]["scatters_checked"]}
        check(same and name not in d001,
              f"{name}: two runs under deterministic algorithms "
              f"{'agree' if same else 'differ'} ({err}), D001 "
              f"{'flags' if name in d001 else 'is clean'}")
    print(f"analysis [{CARD}]: {len(det)} deterministic entries, on seeded "
          f"random inputs, repeat bit for bit under "
          f"torch.use_deterministic_algorithms(True), D001 clean on each")

    # The launch models against the compiler and the runtime.
    card = report.metrics["vmem/card"]
    models = {}
    reports = [e for src in ("graph_reg", "graph_reg_bsp", "pairwise",
                             "flash_attention", "moe", "norm")
               for e in launch_audit.ptxas_entries(src)]
    for where, ln in launch_audit.kernel_launches(card["n_sm"]):
        r = next(r for m, r in reports if ln.symbol in m)
        measured = {"registers": r["registers"],
                    "spill_bytes": r["spill_bytes"],
                    "static_smem_bytes": r["static_smem_bytes"],
                    "resident_blocks": card["resident_blocks"][where]}
        smem = launch_audit.library_dynamic_smem(ln)
        if smem is not None:
            measured["dynamic_smem_bytes"] = smem
        models[where] = {
            "measured": measured,
            "model": {"grid": ln.grid, "threads": ln.threads,
                      "cluster": ln.cluster,
                      "dynamic_smem_bytes": ln.dynamic_smem,
                      "static_smem_bytes": ln.static_smem,
                      "min_blocks": ln.launch_bounds[1]}}
        check(measured["resident_blocks"] >= ln.launch_bounds[1],
              f"{where}: {measured['resident_blocks']} resident blocks, "
              f"fewer than __launch_bounds__' {ln.launch_bounds[1]}")
    by_kernel: dict = {}
    for where, m in models.items():
        by_kernel.setdefault(where.split("/")[0], []).append(m)
    for kern, ms in sorted(by_kernel.items()):
        got = [m["measured"] for m in ms]
        mod = [m["model"] for m in ms]
        print(f"launch model {kern} [{CARD}]: {len(ms)} shape(s), model "
              f"grids {min(g['grid'] for g in mod)}-"
              f"{max(g['grid'] for g in mod)} of "
              f"{min(g['threads'] for g in mod)}-"
              f"{max(g['threads'] for g in mod)} threads, dynamic shared "
              f"memory up to {max(g['dynamic_smem_bytes'] for g in mod)} B "
              f"(launch bounds' minimum {mod[0]['min_blocks']} blocks); "
              f"compiler {got[0]['registers']} registers, static "
              f"{got[0]['static_smem_bytes']} B (model "
              f"{mod[0]['static_smem_bytes']}), {got[0]['spill_bytes']} "
              f"bytes spilled; runtime occupancy "
              f"{min(g['resident_blocks'] for g in got)}-"
              f"{max(g['resident_blocks'] for g in got)} blocks an SM")
    print(f"analysis [{CARD}]: {card['plans_compared']} model plans equal "
          f"the library's, {card['reports']} compiler reports, "
          f"{len(models)} launch models within V001 by the runtime's "
          f"occupancy")

    # Planted twins, one per card-only check.
    where, ln = launch_audit.kernel_launches(card["n_sm"])[0]
    over = dataclasses.replace(
        ln, dynamic_smem=launch_audit.SMEM_BLOCK_BYTES - ln.static_smem + 1)
    twin_v = [f.rule for f in launch_audit.check_launch(over, where=where)]
    check("V001" in twin_v, f"a model 1 byte over the budget: {twin_v}")
    base = AUDIT.get("engine_sequential")

    def with_item():
        fn, args = base.build()
        inner = fn.engine._step

        def step_with_item(*a, **kw):
            m = inner(*a, **kw)
            with boundary("graph_reg_fwd"):
                float(m["loss/total"])      # the planted host sync
            return m
        fn.engine._step = step_with_item
        return fn, args

    sync_twin = graph_audit.EntryPoint("engine_with_item", with_item,
                                       donate=0)
    j004 = [f.detail for f in graph_audit.audit_entry(sync_twin)[0]
            if f.rule == "J004"]
    err = _sync_checked(sync_twin)
    check(j004 and err is not None,
          f"the planted .item() twin: J004 {j004}, sync check {err}")

    def with_index_add():
        gen = torch.Generator("cuda").manual_seed(0)
        x = torch.zeros(64, device="cuda")
        idx = torch.randint(0, 64, (1 << 20,), device="cuda", generator=gen)
        src = torch.randn(1 << 20, device="cuda", generator=gen) * 1e3
        return (lambda x, i, s: x.index_add_(0, i, s)), (x, idx, src)

    det_twin = graph_audit.EntryPoint("index_add_twin", with_index_add)
    d_rules = [f.rule for f in audit_entry_determinism(det_twin)[0]]
    same_on, refused = _twice(det_twin)
    pairs = [_twice(det_twin, deterministic=False)[0] for _ in range(5)]
    check("D001" in d_rules, f"the planted index_add_ twin: D001 {d_rules}")
    check(not all(pairs), "the planted index_add_ twin repeated bit for "
          "bit in all 5 pairs of runs without deterministic algorithms: "
          "the run check could not have failed")
    print(f"analysis twins [{CARD}]: a model 1 byte over {where}'s budget "
          f"-> {sorted(set(twin_v))}; an engine chunk with float() of a "
          f"metric inside graph_reg_fwd's boundary -> J004 {j004}, sync "
          f"check raised: {err}; a float index_add_ of 2^20 values into 64 "
          f"rows -> {sorted(set(d_rules))}, run twice without deterministic"
          f" algorithms: {sum(not p for p in pairs)} of 5 pairs differ, "
          f"under them: "
          f"{'refused: ' + refused if refused else 'bitwise ' + str(same_on)}")
    return {"host_seconds": host_s, "passes": report.passes,
            "launches": {k: v["launches"] for k, v in traced.items()},
            "syncs": syncs, "deterministic": det, "models": models,
            "twin_pairs_differing": sum(not p for p in pairs)}


#: Each kernel line's launch: (wrapper call, its kernel, the path's shape,
#: as in ``analysis.launch_audit.DEFAULT_SHAPES``).
PATH_MODELS = {
    "graph_reg_fwd": ("graph_reg_fwd", "reg_fwd_partials",
                      dict(k=1, B=2176, C=39)),
    "graph_reg_bwd_dlogp": ("graph_reg_bwd_dlogp", "reg_bwd_dlogp",
                            dict(k=1, B=2176, C=39)),
    "graph_reg_bwd_dw": ("graph_reg_bwd_dw", "reg_bwd_dw",
                         dict(k=1, B=2176, C=39)),
    "graph_reg_pairwise": ("graph_reg_pairwise", "reg_fwd_partials",
                           dict(B=2176, C=39)),
    **{name: (name, kern, dict(k=1, B=2176, C=39, T=289, bt=LAYOUT_BT))
       for name, kern in (("graph_reg_bsp_fwd", "bsp_fwd_partials"),
                          ("graph_reg_bsp_bterm", "bsp_bwd_bterm"),
                          ("graph_reg_bsp_dlogp", "bsp_bwd_dlogp"),
                          ("graph_reg_bsp_dw", "bsp_bwd_dw"))},
    "knn_topk": ("knn_topk", "knn_topk_kernel",
                 dict(N=20000, M=20000, D=351, k=10, same=True)),
    "rbf_affinity": ("rbf_affinity", "rbf_affinity_kernel",
                     dict(N=2176, M=2176, D=351, same=True)),
    "flash_attention": ("flash_attention", "flash_fwd_wgmma_kernel",
                        dict(B=4, Tq=2048, Tk=2048, H=12, KV=2, hd=128,
                             dtype="bfloat16")),
    "flash_attention_hd112": ("flash_attention", "flash_fwd_wgmma_kernel",
                              dict(B=4, Tq=2048, Tk=2048, H=64, KV=8,
                                   hd=112, dtype="bfloat16")),
    "moe_dispatch": ("moe_dispatch", "moe_dispatch_kernel",
                     dict(N=8192, d=4096, E=8, k=2, dtype="bfloat16")),
    "moe_combine": ("moe_combine", "moe_combine_kernel",
                    dict(N=8192, d=4096, k=2, dtype="bfloat16")),
    "rms_norm": ("rms_norm", "rms_norm_kernel",
                 dict(rows=8192, d=1536, dtype="bfloat16")),
}


def launch_model_of(name: str, models: dict) -> dict | None:
    """What the analysis phase read of kernel line ``name``'s launch at its
    path's shape: registers, spills and static shared memory from the
    compiler's report, resident blocks from the runtime's occupancy, and
    dynamic shared memory where the library's plan query reports it."""
    import torch
    from repro_torch.analysis import launch_audit
    call, kernel, shape = PATH_MODELS[name]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ln = next(ln for ln in launch_audit.call_launches(call, n_sm=n_sm,
                                                      **shape)
              if ln.kernel == kernel)
    got = models.get(f"{ln.kernel}/{ln.variant}")
    return None if got is None else got["measured"]


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None, metavar="DIR",
                    help="also time the redesigned K1-K10 in turns with "
                         "the same entry points built from DIR's sources")
    args = ap.parse_args()
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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    import numpy
    import scipy
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, numpy {numpy.__version__}, scipy "
          f"{scipy.__version__}, device {torch.cuda.get_device_name(0)}")

    from repro_torch.api import Experiment
    from repro_torch.bench import paper_config, profile_step
    from repro_torch.device import resolve_device
    resolve_device("cuda")   # pins TF32 off for every product below

    build_all()
    fa_build = flash_attention_build_report()
    redesign_build = redesign_build_report()
    class_build = class_routes_build_report()
    pw_build = pairwise_build_report()
    t0 = time.time()
    exp = Experiment(paper_config(), device="cuda").build()
    P = exp.pipeline.__self__.pad
    print(f"host pipeline: n={exp.corpus.X.shape[0]} nodes, "
          f"{exp.plan.n_meta} meta-batches, padded batch P={P}, "
          f"{time.time() - t0:.1f}s")
    graph = graph_build_phase(exp)
    obj = exp.config.objective
    W_path = real_block(exp, P)
    records = kernel_phase(W_path, obj.gamma, obj.kappa)
    records.update(bsp_kernel_phase(W_path, obj.gamma, obj.kappa))
    redesign_cases_phase(P)
    rows_x = exp.corpus.X[block_rows(exp, P)]
    against, run_on_other = (
        ({}, None) if args.against is None else
        against_phase(args.against.resolve(), W_path, obj.gamma, obj.kappa,
                      exp.corpus.X, rows_x, exp.graph.sigma))
    records["knn_topk"] = knn_kernel_phase(exp.corpus.X, exp.config.graph.k)
    knn_kernel_phase(exp.corpus.X, 40, with_times=False)   # lists past one warp
    # Past K_MAX the lists live in the outputs (the global route).
    records["knn_topk"]["global_route"] = {
        f"N={n} k={k}": {key: rec[key] for key in
                         ("route", "segments", "ms", "plain_ms", "rounds",
                          "max_abs_err", "err_over_tol")}
        for n, k in ((4000, 300), (2000, 1000))
        for rec in [knn_kernel_phase(exp.corpus.X[:n], k)]}
    records["rbf_affinity"] = rbf_kernel_phase(rows_x, exp.graph.sigma,
                                               exp.corpus.X)
    records["graph_reg_pairwise"] = pairwise_reg_phase(W_path)
    from repro_torch.kernels import ops
    x_rows = torch.from_numpy(rows_x).cuda()
    logp_path, W_cuda, _ = kernel_inputs(P, 39, W_path, seed=4)
    ops_counts = {
        "rbf_affinity": ops_path("rbf_affinity", lambda: ops.rbf_affinity(
            x_rows, x_rows, exp.graph.sigma)),
        "graph_reg_pairwise": ops_path(
            "graph_reg_pairwise",
            lambda: ops.graph_reg_pairwise(logp_path[0], W_cuda[0])),
    }
    small_step_parity()
    small_step_parity(layout_bt=64)
    dense = train_phase(exp, ("graph_reg_fwd", "graph_reg_bwd_dlogp"),
                        "main path")
    if args.against is not None:
        against["dnn_epoch"] = against_train_phase(
            exp, args.against.resolve(), dense["row"], run_on_other)
    w_grad = w_grad_path(W_path, obj.gamma, obj.kappa)
    t0 = time.time()
    exp_bsp = Experiment(paper_config(layout_bt=LAYOUT_BT),
                         corpus=exp.corpus, eval_data=exp.eval_data,
                         graph=exp.graph, plan=exp.plan, device="cuda").build()
    print(f"block-sparse pipeline: layout_bt={LAYOUT_BT}, tile-list length "
          f"{exp_bsp.pipeline.__self__.layout_len}, {time.time() - t0:.1f}s")
    sparse = train_phase(exp_bsp, ("graph_reg_bsp_fwd", "graph_reg_bsp_bterm",
                                   "graph_reg_bsp_dlogp"),
                         "block-sparse main path")
    print(f"loss/total: dense {dense['row']['loss/total']!r}, block-sparse "
          f"{sparse['row']['loss/total']!r}; eval/acc: dense "
          f"{dense['row']['eval/acc']!r}, block-sparse "
          f"{sparse['row']['eval/acc']!r}")
    # Exact occupancy skips only exact zeros, and K4-K6 sum in K1's and
    # K2's order: the epoch's loss is the dense one bit for bit.
    check(sparse["row"]["loss/total"] == dense["row"]["loss/total"],
          "the block-sparse epoch's loss/total is not the dense one's")
    w_grad_bsp = w_grad_path(W_path, obj.gamma, obj.kappa,
                             layout_bt=LAYOUT_BT)
    dev_graph = train_phase(graph["exp"], ("graph_reg_fwd",
                                           "graph_reg_bwd_dlogp"),
                            "device-graph path")
    print(f"loss/total: host graph {dense['row']['loss/total']!r}, device "
          f"graph {dev_graph['row']['loss/total']!r}; eval/acc: host graph "
          f"{dense['row']['eval/acc']!r}, device graph "
          f"{dev_graph['row']['eval/acc']!r}")
    print(f"device-graph epoch loss/total {dev_graph['row']['loss/total']!r} "
          f"beside {DEVICE_EPOCH_LOSS!r} before K8's redesign (equal: "
          f"{dev_graph['row']['loss/total'] == DEVICE_EPOCH_LOSS})")
    device_weights_phase(exp, graph["exp"], dev_graph["row"])
    checkpoint_phase(exp)
    guard_phase(exp, dense["steps"])
    online = online_phase(exp)
    strategies_phase(exp)
    chaos_phase()
    guard_overhead_phase(exp)
    print_step("main path", profile_step(exp, trace=False))
    print_step("block-sparse main path", profile_step(exp_bsp, trace=False))
    quick = quickstart_phase()

    attn = flash_attention_phase()
    records["flash_attention"] = attn["path bf16"]
    serve_parity_phase()
    serve = serve_phase()
    print(f"serve prefill: K11 {attn['path bf16']['ms']:.4f} ms × "
          f"{serve['counts']['flash_attention']} launches = "
          f"{attn['path bf16']['ms'] * serve['counts']['flash_attention']:.3f}"
          f" ms of the {serve['prefill_ms']:.3f} ms prefill (kernel phase "
          f"time × launches)")

    lm_records = lm_kernel_phase()
    lm_parity_phase()
    lm = lm_train_phase()
    for name, rec in lm_records.items():
        print(f"{name} in an LM step [{CARD}]: {rec['ms']:.5f} ms × "
              f"{lm['counts'][name] // LM_STEPS} launch = "
              f"{100 * rec['ms'] / lm['ms_per_step']:.4f} % of the "
              f"{lm['ms_per_step']:.3f} ms step (kernel phase time)")
    swa_parity_phase()
    swa_serve_phase()

    t_families = time.perf_counter()
    attn112 = flash_attention_hd112_phase()
    moe_recs = moe_kernel_phase()
    norm_recs = norm_kernel_phase()
    family_parity_phase()
    served = {arch: family_serve_phase(arch) for arch in FAMILY_CUTS}
    kimi = served["kimi-k2-1t-a32b"]
    print(f"serve prefill kimi-k2-1t-a32b [{CARD}]: K11 at hd 112 "
          f"{attn112['ms']:.4f} ms × {kimi['k11_launches']} launches = "
          f"{attn112['ms'] * kimi['k11_launches']:.3f} ms of the "
          f"{kimi['prefill_ms']:.3f} ms prefill (kernel phase time × "
          f"launches)")
    mixtral = served["mixtral-8x7b"]
    for name, rec in moe_recs.items():
        n = mixtral["moe_launches"][name]
        print(f"serve prefill mixtral-8x7b [{CARD}]: {name} "
              f"{rec['prefill']['ms']:.5f} ms × {n} launches = "
              f"{rec['prefill']['ms'] * n:.3f} ms of the "
              f"{mixtral['prefill_ms']:.3f} ms prefill (kernel phase time × "
              f"launches)")
    for (label, rows, d), arch in zip(NORM_CASES, (
            SERVE_ARCH, "phi4-mini-3.8b", SERVE_ARCH, "mixtral-8x7b")):
        n = (serve["counts"]["rms_norm"] if arch == SERVE_ARCH
             else served[arch]["norm_launches"])
        ms = norm_recs[label]["ms"]
        cut = FAMILY_CUTS[arch][1] if arch in FAMILY_CUTS else "nothing"
        print(f"serve prefill {arch} [{CARD}]: rms_norm at ({rows}, {d}) "
              f"{ms:.5f} ms × {n} launches = {ms * n:.3f} ms (kernel phase "
              f"time × launches; the smoke's cut: {cut})")
    for arch in LAYOUT_ATTN:
        rec = served[arch]
        print(f"serve prefill {arch} [{CARD}]: K11 {attn[arch]['ms']:.4f} ms "
              f"× {rec['k11_launches']} launches = "
              f"{attn[arch]['ms'] * rec['k11_launches']:.3f} ms of the "
              f"{rec['prefill_ms']:.3f} ms prefill (kernel phase time × "
              f"launches)")
    trained = {arch: family_train_phase(arch) for arch in FAMILY_TRAIN}
    print(f"the LM stack's families (K11 at hd 112, parity, serve, "
          f"training): {time.perf_counter() - t_families:.1f}s")
    t_launch = time.perf_counter()
    launch = launch_phase()
    print(f"launch phase (--smoke card and CPU, dry run): "
          f"{time.perf_counter() - t_launch:.1f}s")
    t_analysis = time.perf_counter()
    analysis = analysis_phase()
    print(f"analysis phase (seven passes on the card, sync and "
          f"deterministic re-runs, twins): "
          f"{time.perf_counter() - t_analysis:.1f}s")

    # K8's and K9's build records: the kernels the path's shapes launch.
    builds = {**redesign_build, "knn_topk": {
        **pw_build["knn_topk"],
        "kernels_past_k_32": {key: pw_build[key] for key in (
            "knn_topk_shared", "knn_topk_global")}},
        "rbf_affinity": pw_build["rbf_affinity"][
            records["rbf_affinity"]["rows_per_block"]]}
    for name in builds:
        rec = records[name]
        rec["share_of_bound"] = rec["bound"][0] / rec["ms"]
        lib = (f"{rec['library']} {rec['library_ms']:.5f} ms" if
               rec["library_ms"] is not None else "no library call")
        print(f"{name} (redesigned): {rec['ms']:.5f} ms against {lib} and "
              f"the plain version {rec['plain_ms']:.5f} ms in the same "
              f"call; bound {rec['bound'][0]:.5f} ms ({rec['bound'][1]}), "
              f"{100 * rec['share_of_bound']:.1f} % of it; "
              f"{builds[name]['registers']} registers, "
              f"{builds[name]['spill_bytes']} bytes spilled"
              + (f", {rec['rows_per_block']} rows a block, "
                 f"{rec['dynamic_smem_bytes']} bytes of dynamic shared "
                 f"memory" if "rows_per_block" in rec else ""))
    print(f"graph_reg_bsp_bterm dynamic shared memory at the path's shape "
          f"(from the library): "
          f"{records['graph_reg_bsp_bterm']['dynamic_smem_bytes']} bytes")

    from repro_torch.kernels import (flash_attention, graph_reg,
                                     graph_reg_bsp, pairwise)
    from repro_torch.kernels import moe as kmoe
    from repro_torch.kernels import norm as knorm
    kernels = []
    for name, rec in records.items():
        b_ms, b_by = rec["bound"]
        # K3 and K7 count on their W-gradient paths (training launches them
        # 0 times, checked above), K8 on the device graph build, K9 and K10
        # on their ops entries, K11 on the serve prefill; the others on
        # their training paths.
        path, counts = {
            "graph_reg_bwd_dw": ("w_grad", w_grad),
            "graph_reg_bsp_dw": ("w_grad_blocksparse", w_grad_bsp),
            "knn_topk": ("graph_build_device", graph["counts"]),
            "rbf_affinity": ("ops.rbf_affinity", ops_counts["rbf_affinity"]),
            "graph_reg_pairwise": ("ops.graph_reg_pairwise",
                                   ops_counts["graph_reg_pairwise"]),
            "flash_attention": ("serve_prefill", serve["counts"]),
        }.get(name, ("train", dense["counts"]) if name in graph_reg.WRAPPERS
              else ("train_blocksparse", sparse["counts"]))
        source = next(mod.SOURCE for mod in (graph_reg, graph_reg_bsp,
                                              pairwise, flash_attention)
                      if name in mod.WRAPPERS)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": counts[name],
            "path": path,
            "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
            "tol_rule": rec.get("tol_rule", TOL_RULE),
            "err_over_tol": rec["err_over_tol"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / rec["ms"],
            "library_ms": rec["library_ms"], "rounds": rec["rounds"],
            **({"kernel_route": rec["kernel_route"],
                "block_k": rec["block_k"],
                "tflop_per_s": rec["tflop_per_s"],
                "share_of_bound": rec["share_of_bound"],
                "registers": fa_build[128]["registers"],
                "spill_bytes": fa_build[128]["spill_bytes"],
                "hgmma_instructions": fa_build["hgmma"]}
               if name == "flash_attention" else {}),
            **({**builds[name], "library": rec.get("library"),
                "share_of_bound": rec["share_of_bound"],
                **{key: rec[key] for key in ("dynamic_smem_bytes",
                                              "rows_per_block", "segments")
                   if key in rec},
                **({"against": {"dir": str(args.against),
                                **against[name]}} if against else {})}
               if name in builds else {}),
            **({"online_refresh": online} if name == "knn_topk" else {}),
            **({"lm_train": {
                "path": "lm_train", "shape_k_B_C": lm_records[name]["shape"],
                "launches": lm["counts"][name],
                **{key: lm_records[name][key] for key in (
                    "max_abs_err", "tol", "err_over_tol", "ms", "plain_ms",
                    "share_of_bound", "rows_per_block",
                    "dynamic_smem_bytes", "rounds", "route", "blocks",
                    "class_chunk", "class_span", "threads", "pass_ms",
                    "lm_heads")
                   if key in lm_records[name]},
                "bound_ms": lm_records[name]["bound"][0],
                "bound_by": lm_records[name]["bound"][1],
                "library_ms": None,
                "class_route_build": {
                    key: r for key, r in class_build.items()
                    if key.startswith("reg_fwd" if name == "graph_reg_fwd"
                                      else "reg_bwd")},
                **({"against": {"dir": str(args.against), **against[
                    f"{name} [LM head]"]}} if against else {})}}
               if name in lm_records else {}),
            **{key: rec[key] for key in ("note", "global_route", "P×P",
                                         "floor_ms", "by_mask_ms")
               if key in rec}})
    b_ms, b_by = attn112["bound"]
    kernels.append({
        "name": "flash_attention_hd112", "route": "cuda",
        "source": flash_attention.SOURCE,
        "replaces": REPLACES["flash_attention"],
        "launches": kimi["k11_launches"],
        "path": "serve_prefill kimi-k2-1t-a32b",
        **{key: attn112[key] for key in (
            "max_abs_err", "tol", "tol_rule", "err_over_tol", "ms",
            "plain_ms", "library_ms", "rounds", "kernel_route", "block_k",
            "tflop_per_s", "note")},
        "kernel_ms": attn112["ms"], "bound_ms": b_ms, "bound_by": b_by,
        "share_of_bound": b_ms / attn112["ms"],
        "registers": fa_build[112]["registers"],
        "spill_bytes": fa_build[112]["spill_bytes"],
        "dynamic_smem_bytes": fa_build[112]["dynamic_smem_bytes"],
        "hgmma_instructions": fa_build["hgmma"],
        "shape": {"B": KIMI_ATTN[0], "T": KIMI_ATTN[1], "H": KIMI_ATTN[2],
                  "KV": KIMI_ATTN[3], "hd": KIMI_ATTN[4]},
        **({"against": {"dir": str(args.against),
                        **against["flash_attention_hd112"]}}
           if against else {})})
    for name, recs in moe_recs.items():
        rec = recs["prefill"]
        kernels.append({
            "name": name, "route": "cuda", "source": kmoe.SOURCE,
            "replaces": None,
            "note": "replaces no TPU kernel: the JAX package dispatches by "
                    "capacity; the plain version is the same function in "
                    "PyTorch ops on the same card tensors",
            "launches": mixtral["moe_launches"][name],
            "path": "serve_prefill mixtral-8x7b",
            **{key: rec[key] for key in (
                "max_abs_err", "tol", "tol_rule", "err_over_tol", "ms",
                "plain_ms", "library_ms", "rounds", "share_of_bound",
                "bytes", "shape")},
            "kernel_ms": rec["ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1],
            "cases": {label: {key: r[key] for key in (
                "ms", "plain_ms", "share_of_bound", "shape", "expert_rows")}
                for label, r in recs.items() if label != "prefill"}})
    rec = norm_recs[NORM_CASES[0][0]]
    kernels.append({
        "name": "rms_norm", "route": "cuda", "source": knorm.SOURCE,
        "replaces": None,
        "note": "replaces no TPU kernel: the JAX package leaves its norms "
                "to XLA; the plain version is apply_norm's float32 "
                "composite on the same card tensors; library_ms is "
                "torch.nn.functional.rms_norm, a yardstick the port never "
                "calls; times over inputs cycled past the L2",
        "launches": serve["counts"]["rms_norm"],
        "path": f"serve_prefill {SERVE_ARCH}",
        "max_abs_err": None, "tol": None, "tol_rule": knorm.RULE,
        "err_over_tol": None, "readings": rec["readings"],
        **{key: rec[key] for key in ("ms", "plain_ms", "library_ms",
                                     "rounds", "share_of_bound", "bytes",
                                     "shape", "plan", "buffers")},
        "kernel_ms": rec["ms"], "bound_ms": rec["bound"][0],
        "bound_by": rec["bound"][1],
        "family_launches": {arch: r["norm_launches"]
                            for arch, r in served.items()},
        "cases": {label: {key: r[key] for key in (
            "ms", "plain_ms", "library_ms", "share_of_bound", "shape",
            "plan", "readings") if key in r}
            for label, r in norm_recs.items() if label != NORM_CASES[0][0]}})
    kernels[[e["name"] for e in kernels].index("flash_attention")][
        "head_layouts"] = {arch: {
            "shape": dict(zip(("B", "T", "H", "KV", "hd"),
                              LAYOUT_ATTN[arch])),
            "path": f"serve_prefill {arch}",
            "launches": served[arch]["k11_launches"],
            **{key: attn[arch][key] for key in (
                "max_abs_err", "tol", "err_over_tol", "ms", "plain_ms",
                "library_ms", "rounds", "kernel_route", "tflop_per_s",
                "share_of_bound")},
            "bound_ms": attn[arch]["bound"][0],
            "bound_by": attn[arch]["bound"][1]} for arch in LAYOUT_ATTN}
    for entry in kernels:
        entry["launch_model"] = launch_model_of(entry["name"],
                                                analysis["models"])
        if entry["name"] in ("graph_reg_fwd", "graph_reg_bwd_dlogp"):
            entry["lm_train_families"] = {
                arch: rec["counts"][entry["name"]]
                for arch, rec in trained.items()}
            entry["quickstart"] = {
                label: quick[label]["steps"]
                for label in ("ssl", "supervised")}
            entry["launch_smoke"] = {
                arch: rec["launches"].get(entry["name"], 0)
                for arch, rec in launch["smoke"].items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
