"""Shared waiver machinery for every pass family, plus stale detection.

The port's copy of the reference's ``waivers.py``: the same marker
grammar, scanner and A001 rule.

A finding any pass emits can be waived inline with an auditable marker::

    self._fast_path_counter += 1  # audit: safe(C001): monotonic, stats-only

The marker names the rule it waives and applies to findings on its own
line or the line below it (marker-above-the-code style).  Findings that
have no source line — the jaxpr-level R/D/S rules attach to a traced
entry point, not a file — are waived with the *scoped* form, placed in
any scanned file (conventionally next to the entry's definition in
``repro_torch/analysis/entrypoints.py``)::

    # audit: safe(R003@engine_*): carry key advanced but never drawn from

where the ``@scope`` is an fnmatch pattern over the finding's ``where``.

Markers are extracted with :mod:`tokenize`, so a marker *example* inside
a docstring (like the ones above) is never treated as a live waiver.

Stale-waiver detection (``A001``): after a run, any scanned marker that
waived nothing — and whose rule family's pass actually ran — is itself a
finding, so waivers cannot rot silently after the code they excused is
fixed.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import io
import re
import tokenize
from typing import Iterable

from repro_torch.analysis.findings import Finding

__all__ = [
    "Waiver",
    "scan_waivers",
    "apply_waivers",
    "stale_waiver_findings",
    "RULE_FAMILY_PASS",
]

#: Rule-id prefix -> the pass family that can emit (and therefore waive)
#: it.  A001 only fires for markers whose family's pass actually ran, so
#: running a pass subset never mislabels out-of-scope markers as stale.
RULE_FAMILY_PASS = {
    "J": "jaxpr",
    "V": "vmem",
    "C": "concurrency",
    "R": "rng",
    "W": "race",
    "D": "determinism",
    "S": "sharding",
}

_MARKER_RE = re.compile(
    r"#\s*audit:\s*safe\(\s*([A-Z]\d{3})"      # rule id
    r"(?:\s*@\s*([\w.\[\]:*?/-]+))?\s*\)"      # optional @scope (fnmatch)
    r"(?::\s*(.*))?")                          # optional reason


@dataclasses.dataclass(frozen=True)
class Waiver:
    """One inline ``# audit: safe(...)`` marker."""

    path: str                  # repo-relative file the marker lives in
    line: int
    rule: str                  # e.g. "C001"
    scope: str | None = None   # fnmatch over Finding.where (scoped form)
    reason: str = ""

    @property
    def key(self) -> tuple[str, int, str]:
        return (self.path, self.line, self.rule)


def scan_waivers(path: str, *, relpath: str | None = None) -> list[Waiver]:
    """Extract every live marker from one source file.

    Only real ``COMMENT`` tokens count — a marker shown inside a docstring
    or string literal is documentation, not a waiver.
    """
    with open(path) as fh:
        source = fh.read()
    rel = relpath if relpath is not None else path
    out: list[Waiver] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _MARKER_RE.search(tok.string)
            if m:
                out.append(Waiver(
                    path=rel, line=tok.start[0], rule=m.group(1),
                    scope=m.group(2), reason=(m.group(3) or "").strip()))
    except tokenize.TokenizeError:
        pass                   # unparseable file: no waivers, no crash
    return out


def _matches(w: Waiver, f: Finding) -> bool:
    if w.rule != f.rule:
        return False
    if w.scope is not None:
        return fnmatch.fnmatchcase(f.where, w.scope)
    # Line form: marker on the flagged line or the line above it, in the
    # same file.
    return (f.path is not None and f.line is not None
            and f.path == w.path and f.line in (w.line, w.line + 1))


def apply_waivers(findings: Iterable[Finding], waivers: Iterable[Waiver],
                  *, used: set | None = None) -> list[Finding]:
    """Drop waived findings; record the used markers' keys in ``used``."""
    waivers = list(waivers)
    kept: list[Finding] = []
    for f in findings:
        hit = next((w for w in waivers if _matches(w, f)), None)
        if hit is None:
            kept.append(f)
        elif used is not None:
            used.add(hit.key)
    return kept


def stale_waiver_findings(waivers: Iterable[Waiver], used: set,
                          ran_passes: Iterable[str]) -> list[Finding]:
    """A001 for every unused marker whose rule family's pass ran."""
    ran = set(ran_passes)
    out: list[Finding] = []
    seen: set[str] = set()
    for w in waivers:
        if w.key in used:
            continue
        if RULE_FAMILY_PASS.get(w.rule[:1]) not in ran:
            continue           # its pass did not run; can't call it stale
        f = Finding(
            "waivers", "A001", w.path,
            f"waiver 'audit: safe({w.rule}"
            + (f"@{w.scope}" if w.scope else "")
            + ")' no longer suppresses any finding — remove it",
            detail=f"{w.rule}" + (f"@{w.scope}" if w.scope else ""),
            line=w.line, path=w.path)
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        out.append(f)
    return out
