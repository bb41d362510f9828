"""Sharding / collective auditor (S-pass) over a recorded run.

The counterpart of the reference's ``sharding_audit.py``.  A dispatch
mode sees ``torch.distributed``'s collectives as ``c10d`` ops (on a
``ProcessGroup`` such as the default group; the recorder names the group
by the role an entry builder gave it with
:func:`~repro_torch.analysis.graph_audit.declare_group`, else by its
``group_name``), and each entry declares the groups it may use
(``EntryPoint.mesh_axes``):

  * ``S001`` — a collective on a group the entry does not declare.
    Entries with no ``mesh_axes`` are single-process contracts: *any*
    collective inside them flags.
  * ``S002`` — a gathering collective (``all_gather`` / ``all_to_all``)
    inside a chunk that the entry did not opt into
    (``EntryPoint.allow_loop_collectives``; reductions keep their
    operand's shape and are allowed by default): a gather every step
    re-materializes its operand every step.
  * ``S003`` — a carry leaf whose placement (a DTensor's placements over
    its mesh, as :mod:`repro_torch.sharding.specs` gives them, or a plain
    tensor's device) differs before and after the run: the in-place carry
    J005 proves would be re-laid out every chunk.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_audit import EntryPoint, Trace, trace_entry

__all__ = ["audit_entry_sharding", "GATHERING"]

#: The gathering collectives S002 polices inside a chunk.
GATHERING = frozenset({"all_gather", "all_to_all"})


def audit_entry_sharding(entry: EntryPoint, trace: Trace | None = None
                         ) -> tuple[list[Finding], dict]:
    """S001/S002/S003 over one recorded run."""
    if trace is None:
        trace = trace_entry(entry)
    declared = tuple(entry.mesh_axes or ())
    allowed = tuple(entry.allow_loop_collectives or ("all_reduce",))
    findings: list[Finding] = []
    audited = 0
    flagged: set = set()
    for op in trace.ops:
        if op.collective is None:
            continue
        audited += 1
        group = op.group or "pg:?"
        if group not in declared and ("S001", op.collective, group) \
                not in flagged:
            flagged.add(("S001", op.collective, group))
            have = (f"declared groups {declared}" if declared
                    else "no declared groups (single-process contract)")
            findings.append(Finding(
                "sharding", "S001", entry.name,
                f"collective {op.collective!r} on group {group!r} but the "
                f"entry has {have} — declare the group in the EntryPoint "
                "or drop the collective",
                detail=f"{op.collective}:{group}"))
        if op.in_chunk and op.collective in GATHERING \
                and op.collective not in allowed \
                and ("S002", op.collective) not in flagged:
            flagged.add(("S002", op.collective))
            findings.append(Finding(
                "sharding", "S002", entry.name,
                f"gathering collective {op.collective!r} inside a chunk "
                "re-materializes its operand every step; hoist it out of "
                "the chunk or opt in via allow_loop_collectives",
                detail=f"loop:{op.collective}"))
    for path, (_, _, before) in sorted(trace.carry_before.items()):
        after = trace.carry_after.get(path)
        if after is not None and after[2] != before:
            findings.append(Finding(
                "sharding", "S003", entry.name,
                f"carry leaf {path} has placement {before} before the chunk "
                f"and {after[2]} after it — make the carry's placement a "
                "fixed point", detail=f"{path}"))
    return findings, {"collectives_audited": audited}
