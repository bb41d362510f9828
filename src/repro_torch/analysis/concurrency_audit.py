"""Concurrency lint: AST pass over the port's threaded modules.

The port's copy of the reference's ``concurrency_audit.py``.  The port's
threads: ``MetaBatchStream``'s replanning thread (``data/pipeline.py``),
the supervisor's watchdog (``resilience/supervisor.py``, which runs the
engine's supervised staging under a ``hang_timeout``), the fault
injector's consumed-on-fire table (``resilience/faults.py``), the shared
``HierarchyCache`` (``core/partition.py``) and the kernel build lock
(``kernels/build.py``).  This pass parses the target files and applies
three rules:

  * ``C001`` — *learned lock discipline*: for every class that uses
    ``with self.<...lock...>:`` anywhere, the set of ``self`` attributes
    touched inside those bodies is the class's guarded set; any read or
    write of a guarded attribute outside a lock body (excluding
    ``__init__``, which runs before the object is shared, and methods
    named ``*_locked``, which by convention require the caller to hold
    the lock) is flagged.  Code inside a nested function defined under a
    ``with`` does **not** count as locked — it runs later, without the
    lock.
  * ``C002`` — a non-daemon ``threading.Thread`` that is never
    ``.join()``-ed anywhere in the file (leaks at shutdown, keeps the
    interpreter alive).
  * ``C003`` — *publication without a happens-before edge*: a value a
    thread target writes (a closure box ``box[k] = ...``, an
    ``x.append(...)``, or a ``self`` attribute) that some function reads
    without any happens-before construct (``join``/``wait``/``get``/
    ``acquire``/``result`` call or a ``with <lock>:``) in that function.
    In the spawning function itself only reads *after* the thread is
    created count.

False positives can be waived inline with an auditable marker on the
flagged line or the line above::

    self._fast_path_counter += 1  # audit: safe(C001): monotonic, stats-only

The marker names the rule it waives, so a suppression never silently
covers a different future finding.

The audited-file list is a registry (:data:`THREADED_MODULES` /
:func:`register_threaded_module`): any module that spawns or coordinates
threads registers itself here and is linted by ``python -m
repro_torch.analysis --ci`` from then on — adding a threaded subsystem without audit coverage
should be a one-line diff review question, not a silent gap.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.waivers import apply_waivers, scan_waivers

__all__ = ["audit_file", "audit_paths", "default_targets",
           "register_threaded_module", "DEFAULT_TARGETS", "THREADED_MODULES"]

#: Registry of threaded modules: name -> repo-relative path.  Names give
#: diffs and reports a stable identity; paths are what the pass parses.
#: The engine spawns no thread itself: it stages batches through the
#: supervisor, whose watchdog thread runs a staging attempt under a
#: ``hang_timeout``; the online manager drives the engine and the k-NN
#: refresh on the caller's thread.  Both stay registered, as in the
#: reference, so a thread added there is linted from the start.
THREADED_MODULES: dict[str, str] = {
    "engine": "src/repro_torch/train/engine.py",
    "pipeline": "src/repro_torch/data/pipeline.py",
    "partition": "src/repro_torch/core/partition.py",
    "supervisor": "src/repro_torch/resilience/supervisor.py",
    "faults": "src/repro_torch/resilience/faults.py",
    "online": "src/repro_torch/online/refresh.py",
    "build": "src/repro_torch/kernels/build.py",
}


def register_threaded_module(name: str, relpath: str) -> None:
    """Add (or re-point) a module in the concurrency-audit registry."""
    if not name or not relpath:
        raise ValueError("register_threaded_module needs a name and a path")
    THREADED_MODULES[name] = relpath


def default_targets() -> tuple[str, ...]:
    """The registry's current path list (insertion-ordered)."""
    return tuple(THREADED_MODULES.values())


#: Back-compat alias: the registry contents at import time.  Prefer
#: :func:`default_targets`, which sees later registrations.
DEFAULT_TARGETS = default_targets()

_HB_CALLS = frozenset({"join", "wait", "get", "acquire", "result"})
_PUBLISH_CALLS = frozenset({"append", "extend", "put", "add"})


def _walk_own(stmts: Iterable[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/lambda
    bodies — those execute in a different dynamic context (possibly a
    different thread, and never under an enclosing ``with`` lock)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue                 # the def itself, never its body
        stack.extend(ast.iter_child_nodes(node))


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_withs(fn: ast.AST, lock_attrs: set[str]) -> list[ast.With]:
    out = []
    for node in _walk_own(getattr(fn, "body", [])):
        if isinstance(node, ast.With):
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr in lock_attrs:
                    out.append(node)
                    break
    return out


def _functions(tree: ast.AST) -> list[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _has_happens_before(fn: ast.AST) -> bool:
    for node in _walk_own(getattr(fn, "body", [])):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HB_CALLS:
            return True
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                name = _self_attr(expr)
                if name is None and isinstance(expr, ast.Name):
                    name = expr.id
                if name is not None and "lock" in name.lower():
                    return True
    return False


# ---------------------------------------------------------------- C001
def _audit_class(cls: ast.ClassDef, where: str,
                 findings: list[Finding]) -> dict:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    lock_attrs = set()
    for m in methods:
        for node in ast.walk(m):   # locks taken even in nested fns count
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and "lock" in attr.lower():
                        lock_attrs.add(attr)
    if not lock_attrs:
        return {"lock_attrs": [], "guarded": []}

    guarded: set[str] = set()
    locked_ids: set[int] = set()
    for m in methods:
        for fn in [m] + [n for n in ast.walk(m)
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and n is not m]:
            for w in _lock_withs(fn, lock_attrs):
                for node in _walk_own(w.body):
                    locked_ids.add(id(node))
                    attr = _self_attr(node)
                    if attr is not None and m.name != "__init__":
                        guarded.add(attr)
    guarded -= lock_attrs

    for m in methods:
        if m.name == "__init__" or m.name.endswith("_locked"):
            continue
        for node in ast.walk(m):
            attr = _self_attr(node)
            if (attr in guarded and id(node) not in locked_ids):
                findings.append(Finding(
                    "concurrency", "C001", f"{where}::{cls.name}",
                    f"guarded attribute self.{attr} accessed outside "
                    f"{'/'.join(sorted(lock_attrs))} in {m.name}()",
                    detail=f"{attr}@{m.name}", line=node.lineno))
    return {"lock_attrs": sorted(lock_attrs), "guarded": sorted(guarded)}


# ------------------------------------------------------------ C002/C003
def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else None
    return name == "Thread"


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _audit_threads(tree: ast.AST, where: str,
                   findings: list[Finding]) -> int:
    functions = _functions(tree)
    fn_by_name = {f.name: f for f in functions}
    source_joins = {
        node.func.value.id
        for node in ast.walk(tree)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "join"
        and isinstance(node.func.value, ast.Name)
    }
    n_threads = 0
    scopes = [(f, list(_walk_own(f.body))) for f in functions]
    scopes.append((None, [n for n in _walk_own(tree.body)]))
    for spawner, own_nodes in scopes:
        for call in (n for n in own_nodes if _is_thread_ctor(n)):
            n_threads += 1
            # ---- C002: non-daemon, never joined --------------------
            daemon = _kw(call, "daemon")
            is_daemon = isinstance(daemon, ast.Constant) and daemon.value
            var = _assigned_name(call, own_nodes)
            if not is_daemon and (var is None or var not in source_joins):
                findings.append(Finding(
                    "concurrency", "C002", where,
                    "non-daemon Thread "
                    + (f"{var!r} " if var else "")
                    + "is never joined in this file",
                    detail=f"thread@{call.lineno}", line=call.lineno))
            # ---- C003: publication without happens-before ----------
            target = _kw(call, "target")
            target_fn = None
            if isinstance(target, ast.Name):
                target_fn = fn_by_name.get(target.id)
            elif (attr := _self_attr(target)) is not None:
                target_fn = fn_by_name.get(attr)
            if target_fn is None:
                continue
            published = _published_names(target_fn)
            if not published:
                continue
            for reader, reader_nodes in scopes:
                if reader is target_fn or reader is None:
                    continue
                if _has_happens_before(reader):
                    continue
                for kind, name in published:
                    line = _first_read(reader_nodes, kind, name,
                                       after=call.lineno
                                       if reader is spawner else 0)
                    if line is not None:
                        findings.append(Finding(
                            "concurrency", "C003", where,
                            f"{reader.name}() reads "
                            f"{'self.' if kind == 'attr' else ''}{name} "
                            f"published by thread target "
                            f"{target_fn.name}() without a join/wait/"
                            "lock happens-before edge",
                            detail=f"{name}@{reader.name}", line=line))
    return n_threads


def _assigned_name(call: ast.Call, own_nodes) -> str | None:
    for node in own_nodes:
        if isinstance(node, ast.Assign) and node.value is call:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                return tgt.id
    return None


def _published_names(target_fn: ast.AST) -> set[tuple[str, str]]:
    """``("name", box)`` for closure-box stores / mutating calls and
    ``("attr", x)`` for ``self.x`` stores inside the thread target."""
    out: set[tuple[str, str]] = set()
    for node in _walk_own(target_fn.body):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Subscript) \
                        and isinstance(tgt.value, ast.Name):
                    out.add(("name", tgt.value.id))
                attr = _self_attr(tgt)
                if attr is not None:
                    out.add(("attr", attr))
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _PUBLISH_CALLS \
                and isinstance(node.func.value, ast.Name):
            out.add(("name", node.func.value.id))
    return out


def _first_read(reader_nodes, kind: str, name: str, *,
                after: int = 0) -> int | None:
    best = None
    for node in reader_nodes:
        line = getattr(node, "lineno", 0)
        if line <= after:
            continue
        hit = False
        if kind == "name":
            hit = (isinstance(node, ast.Name) and node.id == name
                   and isinstance(node.ctx, ast.Load))
        else:
            hit = (_self_attr(node) == name
                   and isinstance(node.ctx, ast.Load)
                   if isinstance(node, ast.Attribute) else False)
        if hit and (best is None or line < best):
            best = line
    return best


# ---------------------------------------------------------------- entry
def audit_file(path: str, *, where: str | None = None,
               used: set | None = None) -> tuple[list[Finding], dict]:
    """Run all concurrency rules over one Python source file.

    Inline ``# audit: safe(Cxxx)`` line waivers are applied here (shared
    machinery in :mod:`repro_torch.analysis.waivers`); the keys of the markers
    that fired land in ``used`` when given, so the CLI's stale-waiver
    sweep (A001) can account for them.
    """
    with open(path) as fh:
        source = fh.read()
    tree = ast.parse(source, filename=path)
    where = where or path
    findings: list[Finding] = []
    classes = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes[node.name] = _audit_class(node, where, findings)
    n_threads = _audit_threads(tree, where, findings)
    # Line waivers match on the finding's path; these findings are all
    # rooted in this file.
    findings = [dataclasses.replace(f, path=where) for f in findings]
    waivers = scan_waivers(path, relpath=where)
    kept = apply_waivers(findings, waivers, used=used)
    metrics = {
        "classes": {name: info for name, info in classes.items()
                    if info["lock_attrs"]},
        "threads_seen": n_threads,
        "suppressed": len(findings) - len(kept),
    }
    return kept, metrics


def audit_paths(paths: Iterable[str] | None = None, *, root: str = ".",
                used: set | None = None) -> tuple[list[Finding], dict]:
    """The concurrency pass entry point: audit every target file.
    ``paths=None`` (default) audits the live :data:`THREADED_MODULES`
    registry, including modules registered after import."""
    import os

    findings: list[Finding] = []
    metrics: dict = {"files": {}}
    for rel in (default_targets() if paths is None else paths):
        path = os.path.join(root, rel)
        file_findings, file_metrics = audit_file(path, where=rel,
                                                 used=used)
        findings.extend(file_findings)
        metrics["files"][rel] = file_metrics
    return findings, metrics
