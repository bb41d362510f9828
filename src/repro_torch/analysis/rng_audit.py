"""RNG lineage auditor (R-pass): the draws of a recorded run.

The counterpart of the reference's ``rng_audit.py``.  PyTorch has no key
values to follow through a jaxpr: a draw reads a ``torch.Generator``'s
state and advances it.  So the recorder (:mod:`.graph_audit`) keeps, for
every random op, the generator's state *before* the draw — a CUDA
(Philox) generator's seed and offset, a CPU (mt19937) generator's whole
state — and this pass reads those states:

  * ``R001`` — two draws of one step read the same state: identical bits
    drawn twice (two generators made from one seed, or a generator
    re-seeded between two draws).  Without steps the whole run is one
    step.
  * ``R002`` — the same state drawn in two steps of a chunk: a generator
    re-seeded (or rebuilt from one seed) every step, so every step replays
    the same stream — the counterpart of a scan carrying its key unsplit.
  * ``R003`` — a draw into a value from which nothing the run returns or
    writes back is computed (a backward liveness pass over storages): the
    draw still advanced the shared stream (the pattern of sampling during
    prefill and throwing the sample away).

Draws with no ``generator=`` read the device's default generator, which is
recorded like any other (the D-pass flags them in seeded modules).
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_audit import EntryPoint, Trace, trace_entry

__all__ = ["analyze_rng", "audit_entry_rng"]


def _live_ops(trace: Trace) -> set[int]:
    """Indices of the ops whose results reach what the run returns or
    leaves behind: one backward pass over storages, from the returned
    values, the arguments' storages an op writes (in-place updates of the
    caller's state) and the ops with effects of their own (collectives,
    host fetches)."""
    needed = set(trace.returned)
    live: set[int] = set()
    for op in reversed(trace.ops):
        outs = {o.storage for o in op.outs}
        if (outs & needed or op.collective is not None or not op.outs
                or (op.inplace and outs & trace.arg_storages)):
            live.add(op.index)
            needed |= {i.storage for i in op.ins}
    return live


def analyze_rng(trace: Trace, *, where: str) -> tuple[list[Finding], dict]:
    """Run the R-pass over one recorded run."""
    draws = [op for op in trace.ops if op.rng is not None]
    findings: list[Finding] = []
    by_step: dict = {}
    steps_of_state: dict = {}
    for op in draws:
        _, state = op.rng
        by_step.setdefault((op.step, state), []).append(op)
        if op.step is not None:
            steps_of_state.setdefault((op.chunk, state), set()).add(op.step)
    for (stp, state), ops in by_step.items():
        if len(ops) >= 2:
            findings.append(Finding(
                "rng", "R001", where,
                f"{len(ops)} draws ({', '.join(o.packet for o in ops)}) "
                f"read the same generator state"
                + (f" in step {stp}" if stp is not None else "")
                + " — draw from one advancing generator, or seed them "
                "apart", detail=f"{ops[0].packet}:x{len(ops)}"
                + (f"@step{stp}" if stp is not None else "")))
    for (chunk, state), steps in steps_of_state.items():
        if len(steps) >= 2:
            findings.append(Finding(
                "rng", "R002", where,
                f"one generator state is drawn in {len(steps)} steps of "
                f"chunk {chunk} — every step replays the same stream "
                "(a generator re-seeded each step)",
                detail=f"chunk{chunk}:x{len(steps)}"))
    live = _live_ops(trace)
    dead = 0
    for op in draws:
        if op.outs and op.index not in live:
            dead += 1
            findings.append(Finding(
                "rng", "R003", where,
                f"draw {op.packet} (op {op.index}) produces a value nobody "
                "reads — the draw still advances the stream",
                detail=f"{op.packet}:dead-draw"))
    metrics = {
        "draws": len(draws),
        "states": len({op.rng[1] for op in draws}),
        "generators": len({op.rng[0] for op in draws}),
        "dead_draws": dead,
        "first_draw_op": draws[0].index if draws else None,
    }
    return findings, metrics


def audit_entry_rng(entry: EntryPoint, trace: Trace | None = None
                    ) -> tuple[list[Finding], dict]:
    """Run ``entry`` (or reuse a shared trace) and run the R-pass."""
    if trace is None:
        trace = trace_entry(entry)
    return analyze_rng(trace, where=entry.name)
