"""Write-race / aliasing auditor (W-pass).

The counterpart of the reference's ``race_audit.py``.  A CUDA grid runs its
blocks in any order and at once, so the port's kernels are written to one
rule: every output element has exactly one writing block (no float
atomics; K1's and K4's per-block partials are summed by an ordered second
pass).  Two blocks writing the same element would overwrite each other's
result in a scheduler-chosen order — the class of bug that reads as
"gradients off by one block" and never crashes.

  * ``W001`` — from the launch models of :mod:`.launch_audit`, no output
    element is written by two blocks that differ outside the output's
    declared accumulation axes (none in the port).

The block-sparse kernels (K4–K7) walk a data-dependent list of tiles, so
their correctness rests on the list contract of
:mod:`repro_torch.core.metabatch`; ``check_tile_list`` and ``check_layout``
are the reference's checks of that contract:

  * ``W002`` — no duplicate active ``(row, col)`` entry: a duplicate makes
    the kernels add the same tile twice.
  * ``W003`` — entries sorted by major line, each line one contiguous run;
    sentinels ``(major, 0, valid=0)`` only on empty lines; length padding
    only at the tail, repeating the last entry with ``valid=0``.  The
    kernels binary-search a strip's entries in the sorted major
    coordinate, which needs this order.
  * ``W004`` — coverage: every major line in ``[0, nt)`` appears, all
    coordinates are in range, and the valid entries reproduce the
    occupancy mask exactly.

``graph_regularizer_blocksparse(validate=True)`` runs the list checks
before launch; ``audit_races`` is the pass entry point: W001 over every
launch model, then the list contract over representative layouts (dense,
block-diagonal, seeded-random, empty).
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.core.metabatch import BlockLayout, layout_from_occupancy

__all__ = ["Finding", "check_launch_races", "check_tile_list",
           "check_layout", "audit_races"]


def check_launch_races(launch, *, where: str) -> list[Finding]:
    """W001 for one launch model: no output element written by two blocks
    that differ outside the output's declared accumulation axes."""
    from repro_torch.analysis.launch_audit import coverage
    findings = []
    for name, cov in coverage(launch).items():
        if cov["overlap"] is not None:
            findings.append(Finding(
                "race", "W001", where,
                f"{launch.kernel}/{launch.variant}: output {name!r} is "
                f"written twice ({cov['overlap']} overlaps an earlier "
                "block) — an overwrite race; give each element one block "
                "or declare the axis in accum_axes",
                detail=f"{launch.variant}:{name}"))
    return findings


def check_tile_list(rows, cols, valid, nt: int, *, major: str = "row",
                    occ=None, where: str = "", name: str = ""
                    ) -> list[Finding]:
    """W002/W003/W004 over one padded tile-id list.

    ``major`` is "row" for the CSR-style list (forward / dL/dlogp sweeps)
    and "col" for the CSC-style list (the Wᵀ·P sweep); the sentinel and
    contiguity conventions apply to the major coordinate.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    valid = np.asarray(valid, dtype=np.int64)
    findings: list[Finding] = []

    def flag(rule: str, msg: str, disc: str) -> None:
        findings.append(Finding("race", rule, where, f"{name}: {msg}",
                                detail=f"{name}:{disc}"))

    T = len(rows)
    if T == 0:
        flag("W004", "empty tile list: no output strip is ever visited",
             "empty")
        return findings
    maj = rows if major == "row" else cols
    mino = cols if major == "row" else rows

    if ((rows < 0) | (rows >= nt) | (cols < 0) | (cols >= nt)).any():
        bad = int(np.argmax((rows < 0) | (rows >= nt)
                            | (cols < 0) | (cols >= nt)))
        flag("W004", f"entry {bad} = ({rows[bad]}, {cols[bad]}) is outside "
             f"the {nt}x{nt} tile grid", "out-of-range")
        return findings

    # Tail padding: trailing valid=0 repeats of the preceding entry.
    core = T
    while (core > 1 and valid[core - 1] == 0
           and rows[core - 1] == rows[core - 2]
           and cols[core - 1] == cols[core - 2]):
        core -= 1

    # W002 — duplicate active tiles double-accumulate.
    pairs = list(zip(rows[:core][valid[:core] == 1],
                     cols[:core][valid[:core] == 1]))
    if len(set(pairs)) < len(pairs):
        seen: set = set()
        dup = next(p for p in pairs if p in seen or seen.add(p))
        flag("W002", f"active tile ({dup[0]}, {dup[1]}) appears twice — "
             "its Eq.-3/4 contribution would be accumulated twice",
             f"dup@{dup[0]},{dup[1]}")

    # W003 — ordering / contiguity / sentinel discipline.
    if (np.diff(maj[:core]) < 0).any():
        flag("W003", "entries are not sorted by major line — an "
             "accumulation strip would be entered twice, re-firing its "
             "first-visit zero-init", "unsorted")
    else:
        for line in np.unique(maj[:core]):
            sel = maj[:core] == line
            minors = mino[:core][sel & (valid[:core] == 1)]
            if (np.diff(minors) <= 0).any():
                flag("W003", f"major line {int(line)} entries are not "
                     "strictly increasing in the minor coordinate",
                     f"minor@{int(line)}")
                break
    line_has_valid = np.zeros(nt, dtype=bool)
    line_has_valid[maj[:core][valid[:core] == 1]] = True
    for i in range(core):
        if valid[i] == 0:
            if mino[i] != 0 or line_has_valid[maj[i]]:
                flag("W003", f"entry {i} = ({rows[i]}, {cols[i]}, valid=0) "
                     "is neither a (major, 0) sentinel on an empty line "
                     "nor tail padding", f"sentinel@{i}")
                break

    # W004 — coverage: every output strip visited, occupancy reproduced.
    visited = np.zeros(nt, dtype=bool)
    visited[maj[:core]] = True
    if not visited.all():
        missing = int(np.argmin(visited))
        flag("W004", f"major line {missing} never visited — its output "
             "block is never flushed (missing sentinel)",
             f"unvisited@{missing}")
    if occ is not None:
        occ = np.asarray(occ).astype(bool)
        want = (set(zip(*np.nonzero(occ))) if major == "row"
                else {(r, c) for c, r in zip(*np.nonzero(occ.T))})
        got = {(int(r), int(c)) for r, c in pairs}
        want = {(int(r), int(c)) for r, c in want}
        if got != want or len(pairs) != int(occ.sum()):
            flag("W004", f"valid entries ({len(pairs)}) do not reproduce "
                 f"the occupancy mask ({int(occ.sum())} occupied tiles)",
             "occ-mismatch")
    return findings


def check_layout(layout: BlockLayout, *, where: str,
                 name: str = "layout") -> list[Finding]:
    """Both padded lists of one :class:`BlockLayout` against the contract."""
    findings = check_tile_list(
        layout.rows, layout.cols, layout.valid, layout.nt,
        major="row", occ=layout.occ, where=where, name=f"{name}.csr")
    findings += check_tile_list(
        layout.crows, layout.ccols, layout.cvalid, layout.nt,
        major="col", occ=layout.occ, where=where, name=f"{name}.csc")
    return findings


def _representative_layouts() -> list[tuple[str, BlockLayout]]:
    nt = 6
    dense = np.ones((nt, nt), dtype=bool)
    block_diag = np.kron(np.eye(nt // 2, dtype=bool),
                         np.ones((2, 2), dtype=bool))
    rng = np.random.default_rng(0)
    random = rng.random((nt, nt)) < 0.35
    empty = np.zeros((nt, nt), dtype=bool)
    return [
        ("dense", layout_from_occupancy(dense, 128)),
        ("block_diag", layout_from_occupancy(block_diag, 128)),
        ("seeded_random", layout_from_occupancy(random, 128,
                                                list_len=48)),
        ("empty", layout_from_occupancy(empty, 128)),
    ]


def audit_races(launches=None) -> tuple[list[Finding], dict]:
    """The W-pass entry point: W001 over every launch model
    (:func:`repro_torch.analysis.launch_audit.kernel_launches` by
    default), then the tile-list contract over representative layouts."""
    from repro_torch.analysis.launch_audit import kernel_launches
    launches = kernel_launches() if launches is None else launches
    findings: list[Finding] = []
    blocks_proven = 0
    for where, launch in launches:
        got = check_launch_races(launch, where=where)
        findings.extend(got)
        if not got:
            blocks_proven += launch.blocks
    tiles_proven = 0
    layouts = _representative_layouts()
    for lname, layout in layouts:
        got = check_layout(layout, where=f"layout:{lname}", name=lname)
        findings.extend(got)
        if not got:
            tiles_proven += 2 * layout.n_active
    metrics = {
        "launches_checked": len(launches),
        "output_blocks_proven": blocks_proven,
        "layouts_checked": len(layouts),
        "tiles_proven_race_free": tiles_proven,
    }
    return findings, metrics
