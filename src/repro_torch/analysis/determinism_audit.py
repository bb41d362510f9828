"""Determinism auditor (D-pass): device and host nondeterminism.

The port's counterpart of the reference's ``determinism_audit.py``.  The
paper's stochastic-partition contract (§2, Eq. 6) is *bit*-reproducible:
the same seed must reproduce the same partition, the same meta-batch
schedule, and the same training trajectory.  Two things break that
silently:

  * **Device**: a floating-point scatter-accumulate (``index_add``,
    ``scatter_add``, ``scatter_reduce(sum)``, ``index_put_(accumulate=
    True)``) whose indices collide: on the card several updates of one
    element land in a scheduler-chosen order (atomics), and float addition
    does not associate in the last ulp.  ``D001`` flags such an op in an
    entry audited under the bit-reproducibility contract
    (``EntryPoint.deterministic``), read off the recorded run
    (:mod:`.graph_audit` records whether the op's target positions
    repeated); collision-free ones stay silent.  On the card
    ``torch.use_deterministic_algorithms(True)`` is the cross-check.
  * **Host**: Python-level nondeterminism inside the *seeded modules* —
    the partitioner, planner, pipeline, refresh and fault-plan code whose
    outputs feed the schedule.  ``D002`` flags set-iteration order feeding
    a decision (``for x in someset``, ``max(someset, key=...)``,
    ``someset.pop()``, materializing a set into a list); ``D003`` flags
    wall-clock or global-state RNG (``np.random.*`` module-level samplers,
    a seedless ``default_rng()`` / ``SeedSequence()`` / ``RandomState()``,
    the stdlib ``random`` module, ``time.*`` feeding an RNG constructor,
    and torch's global generator: ``torch.manual_seed`` or a
    ``torch.rand*`` / ``randn`` / ``randint`` / ``randperm`` /
    ``bernoulli`` / ``multinomial`` call with no ``generator=``).

Both host rules honor the standard ``# audit: safe(D00x): reason`` line
waivers.  The host sweep is the reference's AST pass, copied.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_audit import EntryPoint, Trace, trace_entry
from repro_torch.analysis.waivers import apply_waivers, scan_waivers

__all__ = [
    "audit_entry_determinism",
    "audit_seeded_modules",
    "register_seeded_module",
    "default_seeded_modules",
    "SEEDED_MODULES",
]

#: Modules whose host-side logic feeds the seeded §2/Eq.-6 pipeline.
#: name -> repo-relative path; extend via :func:`register_seeded_module`.
SEEDED_MODULES: dict[str, str] = {
    "partition": "src/repro_torch/core/partition.py",
    "metabatch": "src/repro_torch/core/metabatch.py",
    "pipeline": "src/repro_torch/data/pipeline.py",
    "online": "src/repro_torch/online/refresh.py",
    "faults": "src/repro_torch/resilience/faults.py",
}


def register_seeded_module(name: str, path: str) -> None:
    """Add a module to the D-pass host sweep (repo-relative path)."""
    SEEDED_MODULES[name] = path


def default_seeded_modules() -> dict[str, str]:
    return dict(SEEDED_MODULES)


# ---------------------------------------------------------------------------
# D001 — float scatter-accumulate with colliding indices in a recorded run
# ---------------------------------------------------------------------------
def audit_entry_determinism(entry: EntryPoint, trace: Trace | None = None
                            ) -> tuple[list[Finding], dict]:
    """D001 over one recorded run."""
    if trace is None:
        trace = trace_entry(entry)
    findings: list[Finding] = []
    checked = 0
    flagged: set = set()
    for op in trace.ops:
        if op.collides is None:
            continue
        checked += 1
        if not entry.deterministic or not op.collides:
            continue
        if not op.outs or not op.outs[0].dtype.is_floating_point:
            continue
        if op.packet in flagged:
            continue
        flagged.add(op.packet)
        findings.append(Finding(
            "determinism", "D001", entry.name,
            f"{op.packet} accumulates float updates onto repeated indices — "
            "their order is the scheduler's on the card, breaking bit "
            "reproducibility; use a sorted/segmented reduction or declare "
            "the entry deterministic=False", detail=op.packet))
    return findings, {"scatters_checked": checked}


# ---------------------------------------------------------------------------
# D002 / D003 — host-side AST sweep over the seeded modules
# ---------------------------------------------------------------------------
_SET_METHODS = frozenset({
    "union", "intersection", "difference", "symmetric_difference", "copy",
})
_GLOBAL_SAMPLERS = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "choice", "shuffle", "permutation", "uniform", "normal", "bytes",
})
_RNG_CTORS = frozenset({"default_rng", "SeedSequence", "RandomState",
                        "PRNGKey", "key"})
#: torch's samplers that draw from the global generator without
#: ``generator=``.
_TORCH_SAMPLERS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
})


def _dotted(node) -> str | None:
    """'np.random.seed' for nested Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FnAudit(ast.NodeVisitor):
    """One function (or module top level): track set-typed names, flag
    order-dependent uses (D002) and unseeded entropy sources (D003)."""

    def __init__(self, fn_name: str, emit) -> None:
        self.fn = fn_name
        self.emit = emit
        self.setish: set[str] = set()

    # -- set-ish expression classification --------------------------------
    def _is_setish(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.setish
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) \
                    and node.func.id in ("set", "frozenset"):
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SET_METHODS:
                return self._is_setish(node.func.value)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return self._is_setish(node.left) or self._is_setish(node.right)
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_setish(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.setish.add(t.id)
        else:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.setish.discard(t.id)
        self.generic_visit(node)

    # -- D002: order-dependent consumption --------------------------------
    def visit_For(self, node: ast.For) -> None:
        if self._is_setish(node.iter):
            self.emit("D002", node.lineno, self.fn,
                      "for-loop iterates an unordered set — iteration "
                      "order feeds the loop body's decisions",
                      f"{self.fn}:for")
        self.generic_visit(node)

    def visit_ListComp(self, node: ast.ListComp) -> None:
        for gen in node.generators:
            if self._is_setish(gen.iter):
                self.emit("D002", node.lineno, self.fn,
                          "list comprehension materializes an unordered "
                          "set's iteration order", f"{self.fn}:listcomp")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # max/min with a tie-breaking key over a set; list()/tuple() of a
        # set; someset.pop().
        if isinstance(node.func, ast.Name):
            fid = node.func.id
            if fid in ("max", "min") and node.args \
                    and self._is_setish(node.args[0]) \
                    and any(k.arg == "key" for k in node.keywords):
                self.emit("D002", node.lineno, self.fn,
                          f"{fid}() with a key over an unordered set — "
                          "ties resolve by iteration order",
                          f"{self.fn}:{fid}")
            if fid in ("list", "tuple") and node.args \
                    and self._is_setish(node.args[0]):
                self.emit("D002", node.lineno, self.fn,
                          f"{fid}() materializes an unordered set's "
                          "iteration order", f"{self.fn}:{fid}")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "pop" and not node.args \
                and self._is_setish(node.func.value):
            self.emit("D002", node.lineno, self.fn,
                      "set.pop() removes an arbitrary element",
                      f"{self.fn}:pop")
        self._check_entropy(node)
        self.generic_visit(node)

    # -- D003: wall-clock / global-state entropy --------------------------
    def _check_entropy(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        parts = dotted.split(".")
        if len(parts) >= 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and parts[-1] in _GLOBAL_SAMPLERS:
            self.emit("D003", node.lineno, self.fn,
                      f"{dotted}() draws from the process-global NumPy "
                      "RNG — thread/import order dependent; use a seeded "
                      "Generator", f"{self.fn}:{parts[-1]}")
        elif parts[0] == "random" and len(parts) == 2:
            self.emit("D003", node.lineno, self.fn,
                      f"stdlib {dotted}() uses the global Mersenne "
                      "Twister — not tied to the experiment seed",
                      f"{self.fn}:{parts[-1]}")
        if len(parts) == 2 and parts[0] == "torch":
            if parts[1] in ("manual_seed", "seed"):
                self.emit("D003", node.lineno, self.fn,
                          f"{dotted}() seeds torch's process-global "
                          "generator — use a torch.Generator",
                          f"{self.fn}:torch-{parts[1]}")
            elif parts[1] in _TORCH_SAMPLERS and not any(
                    k.arg == "generator" for k in node.keywords):
                self.emit("D003", node.lineno, self.fn,
                          f"{dotted}() without generator= draws from "
                          "torch's process-global generator",
                          f"{self.fn}:torch-{parts[1]}")
        if parts[-1] in _RNG_CTORS:
            if not node.args and not node.keywords \
                    and parts[-1] in ("default_rng", "SeedSequence",
                                      "RandomState"):
                self.emit("D003", node.lineno, self.fn,
                          f"{dotted}() without a seed draws OS entropy",
                          f"{self.fn}:unseeded-{parts[-1]}")
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Call):
                        d = _dotted(sub.func) or ""
                        if d.startswith("time."):
                            self.emit("D003", node.lineno, self.fn,
                                      f"{d}() seeds an RNG with "
                                      "wall-clock time",
                                      f"{self.fn}:time-seed")


def _audit_source(source: str, *, where_prefix: str, relpath: str
                  ) -> tuple[list[Finding], int]:
    tree = ast.parse(source)
    findings: list[Finding] = []
    n_fns = 0

    def make_emit(fn_name: str):
        def emit(rule, lineno, fn, msg, disc):
            findings.append(Finding(
                "determinism", rule, f"{where_prefix}::{fn}",
                msg, detail=disc, line=lineno, path=relpath))
        return emit

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            n_fns += 1
            auditor = _FnAudit(node.name, make_emit(node.name))
            for stmt in node.body:
                auditor.visit(stmt)
    return findings, n_fns


def audit_seeded_modules(paths: dict[str, str] | None = None, *,
                         root: str = ".", used: set | None = None
                         ) -> tuple[list[Finding], dict]:
    """The host sub-pass entry point: D002/D003 over the seeded modules.

    Line waivers in the scanned files are applied here (their keys land in
    ``used`` when given, so the CLI can account for stale markers).
    """
    paths = default_seeded_modules() if paths is None else paths
    findings: list[Finding] = []
    suppressed = 0
    scanned = 0
    fns = 0
    for name, rel in sorted(paths.items()):
        full = os.path.join(root, rel)
        if not os.path.exists(full):
            continue
        with open(full) as fh:
            source = fh.read()
        scanned += 1
        got, n_fns = _audit_source(source, where_prefix=rel, relpath=rel)
        fns += n_fns
        waivers = scan_waivers(full, relpath=rel)
        kept = apply_waivers(got, waivers, used=used)
        suppressed += len(got) - len(kept)
        findings.extend(kept)
    metrics = {"seeded_modules_scanned": scanned,
               "functions_scanned": fns,
               "suppressed": suppressed}
    return findings, metrics
