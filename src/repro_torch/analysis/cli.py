"""``python -m repro_torch.analysis`` — run the audit passes and gate on
the committed baseline.

Usage::

    python -m repro_torch.analysis                  # on the card
    python -m repro_torch.analysis --device cpu     # plain versions, CPU
    python -m repro_torch.analysis --ci --device cpu   # + nonzero exit on
                                                    # any unbaselined finding
    python -m repro_torch.analysis --only vmem,rng  # pass subsets
    python -m repro_torch.analysis --format github  # GitHub annotations
    python -m repro_torch.analysis --update-baseline   # accept findings

The reference's seven pass families under their names: the structural
tier (``jaxpr``: dispatch-trace contracts — no (B, B) outside a kernel,
no host sync in a chunk, an in-place carry, no captured constant;
``vmem``: the CUDA launch models' shared memory, alignment and coverage;
``concurrency``: thread lint) and the semantic tier (``rng`` generator
states, ``race`` launch-model write races and tile lists,
``determinism``, ``sharding``).  Each entry point is run ONCE per run under
the recorder and the trace is shared by every trace pass.

``--device`` (``cuda`` by default) is where the entries run: without a
GPU the default raises, it never falls back to the CPU.  On the card the
``vmem`` pass also holds every model to the library's plan and to the
compiler's report (:func:`~repro_torch.analysis.launch_audit.
check_against_library`).

The report (``AUDIT_torch_report.json``) always records every finding
plus the per-pass metrics; the *gate* only fails on error-severity
findings whose stable fingerprint is absent from the port's baseline,
``src/repro_torch/analysis/AUDIT_baseline.json``.  Accepting a
finding is therefore an explicit, reviewable commit to the baseline file —
never a side effect of running the tool.  Inline ``# audit: safe(...)``
waivers are honored across all passes, and a waiver that no longer
suppresses anything is itself flagged (``A001``).
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.concurrency_audit import (audit_paths,
                                                   default_targets)
from repro_torch.analysis.determinism_audit import (audit_entry_determinism,
                                                    audit_seeded_modules,
                                                    default_seeded_modules)
from repro_torch.analysis.findings import (AuditReport, Finding,
                                           load_baseline, save_baseline,
                                           unbaselined)
from repro_torch.analysis.graph_audit import audit_entry, trace_entry
from repro_torch.analysis.launch_audit import (check_against_library,
                                               validate_launches)
from repro_torch.analysis.race_audit import audit_races
from repro_torch.analysis.rng_audit import audit_entry_rng
from repro_torch.analysis.sharding_audit import audit_entry_sharding
from repro_torch.analysis.waivers import (Waiver, apply_waivers,
                                          scan_waivers,
                                          stale_waiver_findings)

__all__ = ["build_report", "main", "PASSES"]

PASSES = ("jaxpr", "vmem", "concurrency", "rng", "race", "determinism",
          "sharding")
#: Pass families that read the entries' recorded runs (shared traces).
_JAXPR_PASSES = frozenset({"jaxpr", "rng", "determinism", "sharding"})
#: Extra waiver-bearing files beyond the threaded/seeded registries
#: (scoped waivers for entry-level findings live next to the entries).
_WAIVER_FILES = ("src/repro_torch/analysis/entrypoints.py",
                 "src/repro_torch/kernels/ops.py")
#: The port's committed baseline (never the reference's root file).
BASELINE = os.path.join("src", "repro_torch", "analysis",
                        "AUDIT_baseline.json")


def _repo_root(start: str = ".") -> str:
    """Nearest ancestor holding pyproject.toml (the audit targets are
    repo-relative); falls back to ``start``."""
    d = os.path.abspath(start)
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def _collect_waivers(root: str) -> list[Waiver]:
    """Every inline marker in the audit-covered source files."""
    rels: list[str] = []
    seen: set[str] = set()
    for rel in (tuple(default_targets())
                + tuple(default_seeded_modules().values())
                + _WAIVER_FILES):
        if rel not in seen:
            seen.add(rel)
            rels.append(rel)
    waivers: list[Waiver] = []
    for rel in rels:
        full = os.path.join(root, rel)
        if os.path.exists(full):
            waivers.extend(scan_waivers(full, relpath=rel))
    return waivers


def _traced_entries():
    """[(entry, trace)] for every registered AUDIT entry — run once under
    the recorder, shared across all trace passes."""
    from repro_torch.api.registry import AUDIT

    out = []
    for name in AUDIT:
        entry = AUDIT.get(name)
        out.append((entry, trace_entry(entry)))
    return out


def _run_jaxpr(report: AuditReport, entries=None) -> None:
    metrics: dict = {}
    findings = []
    for entry, closed in (_traced_entries() if entries is None else entries):
        entry_findings, entry_metrics = audit_entry(entry, closed)
        findings.extend(entry_findings)
        metrics[entry.name] = entry_metrics
    report.extend("jaxpr", findings, {"entries": metrics})


def _run_vmem(report: AuditReport, device: str = "cpu") -> None:
    findings, metrics = validate_launches()
    if device == "cuda":
        card, card_metrics = check_against_library()
        findings += card
        metrics["card"] = card_metrics
    report.extend("vmem", findings, metrics)


def _run_concurrency(report: AuditReport, root: str,
                     used: set | None = None) -> None:
    # None = the live THREADED_MODULES registry (supervisor/faults and any
    # later-registered threaded module included) — not a frozen tuple.
    findings, metrics = audit_paths(None, root=root, used=used)
    report.extend("concurrency", findings, metrics)


def _run_rng(report: AuditReport, entries=None) -> None:
    metrics: dict = {}
    findings = []
    for entry, closed in (_traced_entries() if entries is None else entries):
        got, m = audit_entry_rng(entry, closed)
        findings.extend(got)
        metrics[entry.name] = m
    report.extend("rng", findings, {"entries": metrics})


def _run_race(report: AuditReport) -> None:
    findings, metrics = audit_races()
    report.extend("race", findings, metrics)


def _run_determinism(report: AuditReport, root: str, entries=None,
                     used: set | None = None) -> None:
    metrics: dict = {}
    findings = []
    for entry, closed in (_traced_entries() if entries is None else entries):
        got, m = audit_entry_determinism(entry, closed)
        findings.extend(got)
        metrics[entry.name] = m
    host_findings, host_metrics = audit_seeded_modules(root=root, used=used)
    report.extend("determinism", findings + host_findings,
                  {"entries": metrics, **host_metrics})


def _run_sharding(report: AuditReport, entries=None) -> None:
    metrics: dict = {}
    findings = []
    for entry, closed in (_traced_entries() if entries is None else entries):
        got, m = audit_entry_sharding(entry, closed)
        findings.extend(got)
        metrics[entry.name] = m
    report.extend("sharding", findings, {"entries": metrics})


def build_report(passes=PASSES, *, root: str = ".",
                 device: str = "cuda") -> AuditReport:
    """Run the requested pass families on ``device`` (the card unless
    ``"cpu"``; raises without a GPU) and aggregate one report.

    Each pass runs into its own sub-report; findings then flow through the
    central waiver filter (scoped and line markers) before landing in the
    aggregate, and markers that suppressed nothing in any ran pass come
    back as A001 stale-waiver findings.  ``report.traces`` keeps each
    entry's recorded run (its ops and kernel launches).
    """
    from repro_torch.analysis import entrypoints
    entrypoints.set_device(device)
    if device == "cuda" and "vmem" in passes:
        _build_reports()
    report = AuditReport()
    used: set = set()
    waivers = _collect_waivers(root)

    def run(runner, *runner_args):
        sub = AuditReport()
        runner(sub, *runner_args)
        for pass_name, entry in sub.passes.items():
            metrics = {k: v for k, v in entry.items() if k != "findings"}
            pass_findings = [f for f in sub.findings
                             if f.pass_name == pass_name]
            kept = apply_waivers(pass_findings, waivers, used=used)
            report.extend(pass_name, kept, metrics or None)

    entries = _traced_entries() if _JAXPR_PASSES & set(passes) else []
    report.traces = {entry.name: trace for entry, trace in entries}
    if "jaxpr" in passes:
        run(_run_jaxpr, entries)
    if "vmem" in passes:
        run(_run_vmem, device)
    if "concurrency" in passes:
        run(_run_concurrency, root, used)
    if "rng" in passes:
        run(_run_rng, entries)
    if "race" in passes:
        run(_run_race)
    if "determinism" in passes:
        run(_run_determinism, root, entries, used)
    if "sharding" in passes:
        run(_run_sharding, entries)

    stale = stale_waiver_findings(waivers, used, passes)
    report.extend("waivers", stale, {
        "waivers_seen": len(waivers),
        "waivers_used": len(used),
        "waivers_stale": len(stale),
    })
    return report


def _build_reports() -> None:
    """Build every CUDA source with the compiler's report (``-Xptxas -v``)
    that is not in ``build.REPORTS`` yet, all at once."""
    import concurrent.futures

    from repro_torch.kernels import build
    names = [p.stem for p in sorted(build.CSRC.glob("*.cu"))
             if p.stem not in build.REPORTS]
    if names:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(lambda n: build.build(n, verbose=True), names))


def _summary_lines(report: AuditReport) -> list[str]:
    lines = []
    entries = report.metrics.get("jaxpr/entries", {})
    for name, m in entries.items():
        bits = []
        if "bxb_outside_kernels" in m:
            bits.append(f"BxB outside kernels: {m['bxb_outside_kernels']}")
        if "carry_in_place" in m:
            bits.append(f"carry in place: {m['carry_in_place']}")
        if bits:
            lines.append(f"  jaxpr/{name}: " + ", ".join(bits))
    rows = report.metrics.get("vmem/launches_checked")
    if rows is not None:
        worst = report.metrics.get("vmem/worst_smem_bytes", {})
        budget = report.metrics.get("vmem/budget_bytes", 0)
        peak = max(worst.items(), key=lambda kv: kv[1], default=("-", 0))
        card = report.metrics.get("vmem/card")
        lines.append(
            f"  vmem: {rows} launch models of "
            f"{report.metrics.get('vmem/kernels_modelled', 0)}/"
            f"{report.metrics.get('vmem/kernels_in_source', 0)} kernels vs "
            f"{budget} B a block (largest {peak[0]} {peak[1]} B)"
            + (f"; card: {card['plans_compared']} plans, {card['reports']} "
               f"compiler reports" if card else ""))
    files = report.metrics.get("concurrency/files", {})
    if files:
        n_threads = sum(m.get("threads_seen", 0) for m in files.values())
        lines.append(f"  concurrency: {len(files)} files, "
                     f"{n_threads} thread sites audited")
    rng_entries = report.metrics.get("rng/entries", {})
    if rng_entries:
        states = sum(m.get("states", 0) for m in rng_entries.values())
        draws = sum(m.get("draws", 0) for m in rng_entries.values())
        lines.append(f"  rng: {len(rng_entries)} entries, {draws} draws "
                     f"from {states} generator states")
    launches = report.metrics.get("race/launches_checked")
    if launches is not None:
        lines.append(
            f"  race: {launches} launches checked, "
            f"{report.metrics.get('race/output_blocks_proven', 0)} output "
            f"blocks and {report.metrics.get('race/tiles_proven_race_free', 0)}"
            " tile entries proven race-free")
    det_entries = report.metrics.get("determinism/entries", {})
    if det_entries or report.metrics.get("determinism/seeded_modules_scanned"):
        scatters = sum(m.get("scatters_checked", 0)
                       for m in det_entries.values())
        mods = report.metrics.get("determinism/seeded_modules_scanned", 0)
        lines.append(f"  determinism: {scatters} scatters checked, "
                     f"{mods} seeded modules swept")
    sh_entries = report.metrics.get("sharding/entries", {})
    if sh_entries:
        colls = sum(m.get("collectives_audited", 0)
                    for m in sh_entries.values())
        lines.append(f"  sharding: {len(sh_entries)} entries, "
                     f"{colls} collectives audited")
    seen = report.metrics.get("waivers/waivers_seen")
    if seen:
        lines.append(
            f"  waivers: {seen} seen, "
            f"{report.metrics.get('waivers/waivers_used', 0)} used, "
            f"{report.metrics.get('waivers/waivers_stale', 0)} stale")
    return lines


def _github_annotation(f: Finding) -> str:
    """One GitHub Actions workflow command for a (new) finding."""
    loc = ""
    if f.path:
        loc = f"file={f.path}"
        if f.line:
            loc += f",line={f.line}"
    msg = f"[{f.rule}] {f.where}: {f.message}"
    # Workflow-command escaping for the message payload.
    msg = (msg.replace("%", "%25").replace("\r", "%0D")
              .replace("\n", "%0A"))
    return f"::error {loc}::{msg}" if loc else f"::error::{msg}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Audits of the port: dispatch-trace contracts, CUDA "
                    "launch models, concurrency lint, generator states, "
                    "kernel write-races, determinism, collectives.")
    parser.add_argument("--passes", default=",".join(PASSES),
                        help="comma-separated subset of: "
                             + ", ".join(PASSES))
    parser.add_argument("--only", dest="passes",
                        help="alias for --passes (run a pass subset)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the entries run (default: %(default)s; "
                             "raises without a GPU, never falls back)")
    parser.add_argument("--report", default="AUDIT_torch_report.json",
                        help="report output path (default: %(default)s)")
    parser.add_argument("--baseline", default=None,
                        help="baseline path (default: "
                             "src/repro_torch/analysis/AUDIT_baseline.json)")
    parser.add_argument("--format", choices=("text", "github"),
                        default="text",
                        help="finding output format; 'github' emits "
                             "::error workflow annotations for findings "
                             "not in the baseline")
    parser.add_argument("--update-baseline", action="store_true",
                        help="accept all current findings into the baseline"
                             " and exit 0")
    parser.add_argument("--ci", action="store_true",
                        help="CI mode: run everything, write the report, "
                             "exit nonzero on unbaselined findings "
                             "(the default gate — this flag just makes the "
                             "intent explicit in workflows)")
    args = parser.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        parser.error(f"unknown pass(es) {unknown}; choose from {PASSES}")

    root = _repo_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE)
    report = build_report(passes, root=root, device=args.device)

    if args.update_baseline:
        save_baseline(baseline_path, report.gating)
        print(f"baseline updated: {baseline_path} "
              f"({len(report.gating)} accepted findings)")
        return 0

    baseline = load_baseline(baseline_path)
    new = unbaselined(report.gating, baseline)
    report.write(args.report, baseline=baseline)

    for line in _summary_lines(report):
        print(line)
    for f in report.findings:
        if f in new and args.format == "github":
            print(_github_annotation(f))
            continue
        tag = "NEW " if f in new else ("info " if f.severity != "error"
                                       else "base ")
        print(f"{tag}{f.format()}")
    print(f"{len(report.findings)} finding(s), {len(new)} not in baseline "
          f"-> {args.report}")
    if new:
        print("FAIL: new findings above; fix them or (if accepted) run "
              "--update-baseline and commit the baseline", file=sys.stderr)
        return 1
    return 0
