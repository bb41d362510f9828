"""Audits of the port: structural and semantic proofs on every commit.

The counterpart of the reference's ``repro.analysis``: the same seven pass
families under the same names, each rule stated for PyTorch and CUDA (see
:data:`~repro_torch.analysis.findings.RULES` and the module docstrings):

  * :mod:`.graph_audit` (pass ``jaxpr``) — one recorded run of each AUDIT
    registry entry under a dispatch recorder: no (B, B) output outside a
    kernel boundary, no silent promotion, no host sync inside a chunk, an
    in-place carry, no captured constant;
  * :mod:`.launch_audit` (pass ``vmem``) — launch models of every
    ``__global__`` function of ``csrc/``: shared memory and launch bounds,
    alignment, coverage, and on the card the library's plans and the
    compiler's report;
  * :mod:`.concurrency_audit` — AST lock-discipline / thread-lifecycle /
    publication lint over the threaded modules;
  * :mod:`.rng_audit` — the generator states the recorded draws read;
  * :mod:`.race_audit` — write races from the launch models plus the
    block-sparse tile-list contract;
  * :mod:`.determinism_audit` — float scatter-accumulates on colliding
    indices in bit-reproducible entries + host nondeterminism in seeded
    modules;
  * :mod:`.sharding_audit` — collectives vs declared process groups,
    gathers inside a chunk, the carry's placements.

Inline waivers (``# audit: safe(RULE): reason`` / scoped
``safe(RULE@where-glob)``) are shared machinery in :mod:`.waivers`; a
stale marker is itself a finding (A001).  Run ``python -m
repro_torch.analysis --ci`` (``--device cpu`` without a GPU) for the gated
entry point.  ``ops._validate_layout`` runs the tile-list checks before a
block-sparse launch.
"""
from repro_torch.analysis.concurrency_audit import (DEFAULT_TARGETS,
                                                    audit_file, audit_paths)
from repro_torch.analysis.determinism_audit import (SEEDED_MODULES,
                                                    audit_entry_determinism,
                                                    audit_seeded_modules,
                                                    register_seeded_module)
from repro_torch.analysis.findings import (RULES, AuditReport, Finding,
                                           load_baseline, save_baseline,
                                           unbaselined)
from repro_torch.analysis.graph_audit import (EntryPoint, Recorder,
                                              audit_entry,
                                              count_bxb_intermediates,
                                              iter_ops, trace_entry)
from repro_torch.analysis.launch_audit import (SMEM_BLOCK_BYTES, Launch,
                                               Output, check_launch,
                                               kernel_launches,
                                               validate_launches)
from repro_torch.analysis.race_audit import (audit_races, check_launch_races,
                                             check_layout, check_tile_list)
from repro_torch.analysis.rng_audit import analyze_rng, audit_entry_rng
from repro_torch.analysis.sharding_audit import audit_entry_sharding
from repro_torch.analysis.waivers import (Waiver, apply_waivers,
                                          scan_waivers,
                                          stale_waiver_findings)

__all__ = [
    "RULES",
    "Finding",
    "AuditReport",
    "load_baseline",
    "save_baseline",
    "unbaselined",
    "EntryPoint",
    "Recorder",
    "audit_entry",
    "trace_entry",
    "count_bxb_intermediates",
    "iter_ops",
    "Launch",
    "Output",
    "SMEM_BLOCK_BYTES",
    "kernel_launches",
    "check_launch",
    "validate_launches",
    "DEFAULT_TARGETS",
    "audit_file",
    "audit_paths",
    "analyze_rng",
    "audit_entry_rng",
    "audit_races",
    "check_launch_races",
    "check_layout",
    "check_tile_list",
    "audit_entry_determinism",
    "audit_seeded_modules",
    "register_seeded_module",
    "SEEDED_MODULES",
    "audit_entry_sharding",
    "Waiver",
    "scan_waivers",
    "apply_waivers",
    "stale_waiver_findings",
    "build_report",
]


def build_report(*args, **kwargs):
    """Lazy alias for :func:`repro_torch.analysis.cli.build_report`."""
    from repro_torch.analysis.cli import build_report as _build

    return _build(*args, **kwargs)
