"""Structured findings, report serialization, and the CI baseline gate.

The port's copy of the reference's ``findings.py``.  Every analysis pass
emits :class:`Finding` rows.  A finding's :attr:`Finding.fingerprint` is
deliberately *stable* — ``pass:rule:where:detail`` with no line numbers
or timestamps — so a committed baseline
(``src/repro_torch/analysis/AUDIT_baseline.json``) keeps accepting a known
finding across unrelated edits, while any *new* finding (or a known one
moving to a new site) fails the gate.  The fingerprint and the baseline
file format are the reference's: a baseline written by one package is
read by the other.

The report (``AUDIT_torch_report.json`` by default) carries the findings
plus per-pass metrics (the fused entries' (B, B) count, the launch models
checked, ...), so CI artifacts record the proven invariants, not just
pass/fail.

Every rule id keeps the reference's id; :data:`RULES` says what it means
for PyTorch dispatch traces and hand-written CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

__all__ = [
    "RULES",
    "Finding",
    "AuditReport",
    "load_baseline",
    "save_baseline",
    "unbaselined",
]

#: Rule ids, one table for the whole toolkit (docs + tests key off these).
#: A "trace" is one run of an entry under the dispatch recorder
#: (:mod:`repro_torch.analysis.graph_audit`); a "kernel boundary" is
#: :func:`repro_torch.kernels.boundary`; a "chunk" is the engine's group of
#: ``scan_chunk`` steps.
RULES = {
    # dispatch-trace auditor (pass "jaxpr", the reference's name)
    "J000": "auditor self-check failed: the graph_reg_ref canary (plain "
            "kernels/ref.py outside any kernel boundary) counted fewer "
            "(B, B) outputs than it must",
    "J001": "output of at least the size threshold (1 MiB) made outside a "
            "kernel boundary",
    "J002": "(B, B) output made outside a kernel boundary",
    "J003": "silent dtype promotion: a float64 output, or a widening cast "
            "of a non-scalar out of the entry's declared compute dtype",
    "J004": "host sync inside a chunk (_local_scalar_dense / item / "
            "tolist / is_nonzero / nonzero, or a device-to-host copy)",
    "J005": "carry leaf not updated in place over a chunk: its storage "
            "changed, or a second full-size copy of it was made inside the "
            "chunk",
    "J006": "tensor of at least 1 MiB read by the entry's ops that is "
            "neither an argument, reachable from one, nor made in the trace "
            "(a captured constant)",
    # CUDA launch-model checker (pass "vmem", the reference's name)
    "V001": "a block's dynamic + static shared memory exceeds 232,448 B, "
            "or the blocks an SM that __launch_bounds__' minimum promises do "
            "not fit 228 KB / 64 K registers / 2,048 threads",
    "V002": "a TMA base or box not 16-byte aligned or not cut evenly by the "
            "128-byte swizzle, or a 16-byte vector / cp.async access on a "
            "row that is not 16-byte aligned",
    "V003": "a grid whose blocks do not cover the output exactly, address "
            "past it, or do not divide into the launch's clusters",
    "V004": "not applicable: the port has no first-match tuning table "
            "(kernels/tuning.py refuses pinned tiles, the launch plans are "
            "computed by the library); never emitted",
    "V005": "a __global__ function of csrc/ with no launch model, a model "
            "whose __launch_bounds__ differ from the source's, or (on the "
            "card) a model whose plan differs from the library's",
    # concurrency lint
    "C001": "lock-guarded attribute accessed outside the lock",
    "C002": "non-daemon thread started but never joined",
    "C003": "value published by a thread body read without a "
            "happens-before edge (join/wait/get/lock)",
    # RNG lineage auditor (recorded draws)
    "R001": "two draws of one step read the same generator state (seed and "
            "offset, or the CPU generator's state), e.g. two generators "
            "made from one seed",
    "R002": "the same generator state drawn in two steps of a chunk (a "
            "generator re-seeded every step)",
    "R003": "random draw into a value that is never read or returned",
    # write-race auditor
    "W001": "two blocks of a launch write the same output element outside "
            "a declared accumulation axis",
    "W002": "duplicate active tile entry in a block-sparse tile list "
            "(double accumulation)",
    "W003": "tile list breaks the contiguous accumulation-strip / "
            "tail-padding convention",
    "W004": "tile-list sentinel/coverage violation (output strip never "
            "visited, out-of-range tile, or occupancy mismatch)",
    # determinism auditor
    "D001": "float index_add / scatter_add / scatter_reduce(sum) / "
            "index_put_(accumulate=True) whose indices are not proven "
            "collision-free, in a deterministic entry",
    "D002": "iteration order of an unordered set feeds a decision in a "
            "seeded module",
    "D003": "wall-clock or global-state RNG used in a seeded module "
            "(NumPy's, the stdlib's, or torch's: manual_seed, or a "
            "rand / randn / randint / randperm / bernoulli / multinomial "
            "call with no generator=)",
    # sharding / collective auditor
    "S001": "collective on a process group the entry does not declare",
    "S002": "all_gather / all_to_all inside a chunk",
    "S003": "carry leaf whose placement (sharding/specs.py) differs before "
            "and after a chunk",
    # waiver hygiene
    "A001": "stale waiver: an '# audit: safe(...)' marker that no longer "
            "suppresses any finding",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured audit finding.

    ``where`` names the audited unit (an AUDIT entry-point name, a
    ``kernel/variant@shape`` launch-model coordinate, or
    ``file::Class.attr``);
    ``detail`` is a short stable discriminator so two findings of the same
    rule at the same site fingerprint apart.  ``line`` and ``path`` (the
    repo-relative source file, when the finding has one) are display/waiver
    metadata and never part of the fingerprint.
    """

    pass_name: str           # "jaxpr" | "vmem" | "concurrency" | "rng" | ...
    rule: str                # e.g. "J001"
    where: str
    message: str
    detail: str = ""
    severity: str = "error"  # "error" gates; "info" is report-only
    line: int | None = None
    path: str | None = None

    @property
    def fingerprint(self) -> str:
        return f"{self.pass_name}:{self.rule}:{self.where}:{self.detail}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        d["rule_doc"] = RULES.get(self.rule, "")
        return d

    def format(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"[{self.rule}] {loc}: {self.message}"


@dataclasses.dataclass
class AuditReport:
    """Aggregated result of one audit run, JSON-serializable for CI."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    passes: dict[str, dict] = dataclasses.field(default_factory=dict)
    #: entry name -> the recorded run every trace pass read (not written
    #: to the report file)
    traces: dict[str, Any] = dataclasses.field(default_factory=dict)

    def extend(self, pass_name: str, findings: Iterable[Finding],
               metrics: dict | None = None) -> None:
        findings = list(findings)
        self.findings.extend(findings)
        entry = self.passes.setdefault(pass_name, {"findings": 0})
        entry["findings"] += sum(1 for f in findings
                                 if f.severity == "error")
        if metrics:
            entry.update(metrics)
            self.metrics.update(
                {f"{pass_name}/{k}": v for k, v in metrics.items()})

    @property
    def gating(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def to_dict(self, *, baseline: set[str] | None = None) -> dict:
        new = unbaselined(self.gating, baseline or set())
        return {
            "version": 1,
            "passes": self.passes,
            "metrics": self.metrics,
            "findings": [f.to_dict() for f in self.findings],
            "baseline_fingerprints": sorted(baseline or ()),
            "new_findings": sorted(f.fingerprint for f in new),
        }

    def write(self, path: str, *, baseline: set[str] | None = None) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(baseline=baseline), fh, indent=2)
            fh.write("\n")


def load_baseline(path: str) -> set[str]:
    """Accepted-finding fingerprints from a committed baseline file.

    A missing file is an empty baseline (the common healthy state), not an
    error — the gate then fails on *any* finding.
    """
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    return set(data.get("fingerprints", []))


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    fingerprints = sorted({f.fingerprint for f in findings
                           if f.severity == "error"})
    with open(path, "w") as fh:
        json.dump({"fingerprints": fingerprints}, fh, indent=2)
        fh.write("\n")


def unbaselined(findings: Iterable[Finding],
                baseline: set[str]) -> list[Finding]:
    """Findings whose fingerprint the committed baseline does not accept."""
    return [f for f in findings
            if f.severity == "error" and f.fingerprint not in baseline]
