"""Dispatch-trace auditor: proofs over one recorded run of each entry.

The counterpart of the reference's ``jaxpr_audit.py``.  PyTorch has no
jaxpr, so an entry is *run* once on tiny inputs under a
:class:`Recorder` (a ``TorchDispatchMode`` beside a ``TorchFunctionMode``
for the host fetches that never reach the dispatcher, ``tolist`` and
``numpy``), which keeps, for every op:

  * its name, its outputs' shapes, dtypes and storages, its inputs'
    storages;
  * the kernel boundary it ran in (:func:`repro_torch.kernels.boundary`,
    which every kernel wrapper enters around its CUDA branch and its plain
    branch; a dispatch mode cannot see a ctypes launch, so the boundary is
    the counterpart of the reference's ``pallas_call`` eqn);
  * the engine step and chunk it ran in (:func:`Recorder.begin_step` /
    :func:`Recorder.end_step`, which an engine entry calls around each
    step of its chunk of ``scan_chunk`` steps);
  * for a random op, the generator it drew from and that generator's state
    before the draw; for a collective, its process group; for a float
    scatter-accumulate, whether its indices collided.

The other trace passes (R, D001, S) read the same :class:`Trace`.  This
module's rules:

  * ``J001`` — an output of at least ``dense_bytes`` made outside a kernel
    boundary;
  * ``J002`` — (B, B) outputs made outside a kernel boundary beyond the
    entry's budget (0 for every fused path).  The plain ``kernels/ref.py``
    regularizer called directly is the canary that must still trip the
    counter — ``J000`` fires if it stops doing so;
  * ``J003`` — a float64 output, or a widening cast of a non-scalar out of
    the entry's declared ``compute_dtype``;
  * ``J004`` — a host sync inside a chunk: ``_local_scalar_dense`` (what
    ``item()``, ``float()`` and ``bool()`` of a tensor dispatch to),
    ``is_nonzero``, ``nonzero``, ``tolist``, ``numpy`` or a device-to-host
    copy, inside a kernel boundary or outside (a wrapper is Python code
    that could fetch on either branch).  A fetch between chunks (the
    guard's one fetch a window) is the design, not a finding.  On the card
    :func:`trace_entry` ``(sync_check=True)`` also runs each chunk under
    ``torch.cuda.set_sync_debug_mode("error")``;
  * ``J005`` — a carry leaf (``EntryPoint.donate`` names the argument that
    holds the carry) whose storage changed over the run, or of which a
    second full-size copy was made inside a chunk: the port's carry is
    updated in place, the counterpart of the reference's donated carry;
  * ``J006`` — a tensor of at least ``const_bytes`` that the entry's ops
    read but that is neither an argument, reachable from one, nor made in
    the trace: a captured constant.

Views and constant splats (``empty``, ``zeros``, ``full``, ``expand``, ...)
make nothing and are not counted, as the reference skips
``broadcast_in_dim``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Callable, Iterator

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.boundary import current as _kernel

__all__ = [
    "EntryPoint",
    "OpRecord",
    "Recorder",
    "Trace",
    "count_bxb_intermediates",
    "audit_entry",
    "trace_entry",
    "iter_ops",
    "declare_group",
    "reachable_tensors",
]

#: Ops that make no values: views are excluded by their schema, and these
#: allocate or splat a constant (the reference skips ``broadcast_in_dim``).
SPLAT_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "fill", "fill_", "zero_", "scalar_tensor",
    "expand", "lift_fresh", "lift_fresh_copy", "detach", "alias",
    "set_", "resize_", "arange",
})
#: Host syncs (J004): what the dispatcher sees, and the fetches that only a
#: function mode sees.
SYNC_OPS = frozenset({"_local_scalar_dense", "is_nonzero", "nonzero",
                      "equal", "tolist", "numpy"})
#: Random draws (R-pass).
RANDOM_OPS = frozenset({
    "bernoulli", "bernoulli_", "multinomial", "rand", "rand_like", "randn",
    "randn_like", "randint", "randint_like", "randperm", "normal", "normal_",
    "uniform", "uniform_", "random_", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "native_dropout", "poisson", "binomial",
})
#: Float scatter-accumulates (D001).
SCATTER_ADD_OPS = frozenset({"index_add", "index_add_", "scatter_add",
                             "scatter_add_", "scatter_reduce",
                             "scatter_reduce_", "index_put", "index_put_",
                             "_index_put_impl_"})
#: Collectives by their ``c10d`` op, named as the reference names them.
COLLECTIVES = {
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "broadcast_": "broadcast", "reduce_": "reduce", "barrier": "barrier",
    "send": "send", "recv_": "recv", "gather_": "gather",
    "scatter_": "scatter",
}

_FLOAT_WIDTH = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4,
                torch.float64: 8}

#: Process-group roles: a group's ``group_name`` -> the role an entry
#: declares (``EntryPoint.mesh_axes``); see :func:`declare_group`.
_GROUP_ROLES: dict[str, str] = {}


def declare_group(group, role: str) -> None:
    """Name a process group's role (e.g. the engine's ``"data"`` group) so
    the S-pass can hold its collectives to an entry's ``mesh_axes``."""
    _GROUP_ROLES[group.group_name] = role


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One audited entry point: how to run it and what to expect.

    ``build()`` returns ``(fn, args)``; the auditor runs ``fn(*args)`` once
    under the recorder.  All thresholds are part of the committed registry,
    so "no unexpected dense growth" is a reviewable contract.
    """

    name: str
    build: Callable[[], tuple[Callable, tuple]]
    #: Exact-shape (B, B) budget: ``B`` enables the counter, ``expect_bxb``
    #: is the allowed count (None = informational only, e.g. the canary).
    B: int | None = None
    expect_bxb: int | None = 0
    #: The canary must still *trip* the counter at >= this many.
    canary_min_bxb: int | None = None
    #: J001 byte threshold for any single output outside a kernel.
    dense_bytes: int = 1 << 20
    #: Declared low-precision compute dtype ("bfloat16") for J003, or None.
    compute_dtype: str | None = None
    allow_f64: bool = False
    #: Index of the argument holding the carry that must be updated in place
    #: over a chunk (params, optimizer state, strategy carry) for J005/S003;
    #: None = the entry has no carry.
    donate: int | None = None
    #: J006 threshold for captured constants.
    const_bytes: int = 1 << 20
    #: Process-group roles the entry may run collectives on (S001); None =
    #: single-process contract.
    mesh_axes: tuple[str, ...] | None = None
    #: Under the bit-reproducibility contract (D001 applies)?
    deterministic: bool = True
    #: Collectives tolerated inside a chunk (S002); reductions keep their
    #: operand's shape, gathers do not — hence the default.
    allow_loop_collectives: tuple[str, ...] = ("all_reduce",)
    #: A context manager factory entered around build and run (e.g. a
    #: world-1 process group), or None.
    context: Callable[[], Any] | None = None


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    shape: tuple[int, ...]
    dtype: torch.dtype
    device: str
    storage: tuple
    nbytes: int


@dataclasses.dataclass
class OpRecord:
    """One recorded op."""

    index: int
    name: str                         # e.g. "aten.mm.default"
    packet: str                       # e.g. "mm"
    outs: tuple[TensorInfo, ...]      # fresh or written outputs
    ins: tuple[TensorInfo, ...]
    kernel: str | None                # open kernel boundary, if any
    step: int | None                  # open engine step, if any
    chunk: int | None                 # the chunk of ``step``
    in_chunk: bool
    view: bool = False                # outputs alias an input, read only
    inplace: bool = False             # writes into an input
    rng: tuple | None = None          # (generator key, state) of a draw
    group: str | None = None          # role or name of a collective's group
    collective: str | None = None     # "all_gather", "all_reduce", ...
    src_dtype: torch.dtype | None = None     # a cast's input dtype
    d2h: bool = False                 # a device-to-host copy
    collides: bool | None = None      # a scatter-accumulate's indices


def _address(t: torch.Tensor) -> tuple:
    try:
        return (str(t.device), t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):
        return (str(t.device), id(t))


def _storage_key(t: torch.Tensor, gens: dict | None = None) -> tuple:
    """A storage's identity: its address and, with ``gens``, the number of
    storages made at that address so far in the run (an address is reused
    once its storage is freed)."""
    addr = _address(t)
    return addr + ((gens or {}).get(addr, 0),)


def _info(t: torch.Tensor, gens: dict | None = None) -> TensorInfo:
    try:
        nbytes = t.untyped_storage().nbytes()
    except (RuntimeError, NotImplementedError):
        nbytes = t.numel() * t.element_size()
    return TensorInfo(tuple(t.shape), t.dtype, str(t.device),
                      _storage_key(t, gens), nbytes)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def reachable_tensors(obj, path: str = "", *, _seen=None,
                      _depth: int = 0) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor reachable from ``obj`` through
    lists, tuples, dicts, dataclasses and plain objects' attributes."""
    seen = set() if _seen is None else _seen
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if id(obj) in seen or _depth > 12 or obj is None or isinstance(
            obj, (str, bytes, int, float, bool, torch.Generator,
                  torch.device, torch.dtype)):
        return []
    seen.add(id(obj))
    out: list = []
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    elif hasattr(obj, "__dict__") and not callable(obj):
        items = vars(obj).items()
    else:
        return []
    for key, val in items:
        out += reachable_tensors(val, f"{path}/{key}" if path else str(key),
                                 _seen=seen, _depth=_depth + 1)
    return out


def _generator_state(gen: torch.Generator | None,
                     device: torch.device) -> tuple:
    """(generator key, state) before a draw: the CUDA Philox generator's
    (seed, offset), the CPU mt19937 generator's whole state (digested)."""
    if gen is None:
        gen = (torch.cuda.default_generators[device.index or 0]
               if device.type == "cuda" else torch.default_generator)
    if gen.device.type == "cuda":
        state = ("philox", gen.initial_seed(), gen.get_offset())
    else:
        state = ("mt19937", hashlib.sha1(
            gen.get_state().numpy().tobytes()).hexdigest()[:20])
    return (f"{gen.device}:{id(gen)}", state)


def _collides(packet: str, args, kwargs) -> bool:
    """Whether a scatter-accumulate's target positions repeat."""
    if packet.startswith("index_add"):
        idx = args[2]
        return idx.unique().numel() != idx.numel()
    if packet.startswith(("index_put", "_index_put")):
        idx = [i for i in args[1] if i is not None]
        if not idx:
            return True
        coords = torch.stack([i.reshape(-1).to(torch.int64) for i in
                              torch.broadcast_tensors(*idx)], 1)
        return coords.unique(dim=0).shape[0] != coords.shape[0]
    dim, index = args[1], args[2]
    dim = dim % index.dim()
    grids = torch.meshgrid(*[torch.arange(s, device=index.device)
                             for s in index.shape], indexing="ij")
    coords = torch.stack([index.reshape(-1) if d == dim
                          else grids[d].reshape(-1)
                          for d in range(index.dim())], 1)
    return coords.unique(dim=0).shape[0] != coords.shape[0]


class _FetchMode(TorchFunctionMode):
    """Records the host fetches that never reach the dispatcher."""

    def __init__(self, recorder: "Recorder"):
        super().__init__()
        self.recorder = recorder

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("tolist", "numpy") and args \
                and isinstance(args[0], torch.Tensor):
            self.recorder.record_fetch(name, args[0])
        return func(*args, **(kwargs or {}))


class _DispatchMode(TorchDispatchMode):
    def __init__(self, recorder: "Recorder"):
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return self.recorder.record(func, args, kwargs)


class Recorder:
    """Records every op of a run: ``with Recorder() as rec: fn(*args)``.

    ``chunk_steps`` is the engine's ``scan_chunk`` (steps per chunk); an
    entry marks its steps with :meth:`begin_step` / :meth:`end_step`.
    ``sync_check`` (the card only) makes any host sync from a chunk's
    first step to the end of its last raise
    (``torch.cuda.set_sync_debug_mode("error")``); the recorder's own
    reads of the indices of a scatter-accumulate are exempt.
    """

    active: "Recorder | None" = None

    def __init__(self, chunk_steps: int = 0, *, sync_check: bool = False):
        self.ops: list[OpRecord] = []
        self.chunk_steps = chunk_steps
        self.sync_check = sync_check
        self._checking = False
        self._step: int | None = None
        self._last_closed: int | None = None
        self._modes = []
        self._sched: dict = {}
        #: storages made so far at each address (see :func:`_storage_key`)
        self.gens: dict = {}

    # -- steps -----------------------------------------------------------
    def begin_step(self, step: int) -> None:
        self._step = step
        self._sync_debug(True)

    def end_step(self) -> None:
        if self._step is not None:
            self._last_closed = self._step
            if not self.chunk_steps \
                    or (self._step + 1) % self.chunk_steps == 0:
                self._sync_debug(False)
        self._step = None

    def _sync_debug(self, on: bool) -> None:
        if self.sync_check and on != self._checking:
            torch.cuda.set_sync_debug_mode("error" if on else 0)
            self._checking = on

    def _where(self) -> tuple[int | None, int | None, bool]:
        S = self.chunk_steps
        if self._step is not None:
            return self._step, (self._step // S if S else 0), True
        last = self._last_closed
        if last is not None and S and (last + 1) % S:
            return None, last // S, True
        return None, None, False

    # -- recording -------------------------------------------------------
    def _schema(self, func) -> tuple[bool, bool]:
        """(view, in-place) of an op, worked out once."""
        if func not in self._sched:
            returns = func._schema.returns
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in returns)
            inplace = any(r.alias_info is not None and r.alias_info.is_write
                          for r in returns)
            self._sched[func] = (view, inplace)
        return self._sched[func]

    def record(self, func, args, kwargs):
        packet = func._overloadpacket.__name__
        rng = None
        if packet in RANDOM_OPS:
            device = next((t.device for t in _tensors((args, kwargs))),
                          kwargs.get("device") or torch.device("cpu"))
            rng = _generator_state(kwargs.get("generator"),
                                   torch.device(device))
        collides = None
        if packet in SCATTER_ADD_OPS and (
                not packet.startswith(("index_put", "_index_put"))
                or (len(args) > 3 and args[3])
                or kwargs.get("accumulate")) and (
                not packet.startswith("scatter_reduce")
                or (args[4] if len(args) > 4 else kwargs.get("reduce"))
                == "sum"):
            checking = self._checking
            self._sync_debug(False)
            try:
                collides = _collides(packet, args, kwargs)
            finally:
                self._sync_debug(checking)
        group = coll = None
        if func.namespace == "c10d":
            coll = COLLECTIVES.get(packet, packet)
            group = "pg:?"
            for a in args:
                if isinstance(a, torch.ScriptObject):
                    try:     # the process group; a ReduceOp does not unbox
                        pg = torch._C._distributed_c10d.ProcessGroup.unbox(a)
                    except (RuntimeError, AttributeError):
                        continue
                    group = _GROUP_ROLES.get(pg.group_name,
                                             f"pg:{pg.group_name}")
                    break
        ins = tuple(_info(t, self.gens) for t in _tensors((args, kwargs)))
        out = func(*args, **kwargs)
        view, inplace = self._schema(func)
        outs = _tensors(out)
        if not view and not inplace:
            fresh = {_address(t) for t in outs} - {
                i.storage[:2] for i in ins}
            for addr in fresh:
                self.gens[addr] = self.gens.get(addr, 0) + 1
        step, chunk, in_chunk = self._where()
        src_dtype = None
        d2h = False
        if packet in ("_to_copy", "to", "copy_", "_copy_from") and ins:
            src = _tensors(args)
            if src:
                s = src[1] if packet == "copy_" and len(src) > 1 else src[0]
                src_dtype = s.dtype
                dst = _tensors(out)
                d2h = (s.device.type == "cuda" and bool(dst)
                       and dst[0].device.type == "cpu")
        self.ops.append(OpRecord(
            index=len(self.ops), name=str(func), packet=packet,
            outs=tuple(_info(t, self.gens) for t in outs), ins=ins,
            kernel=_kernel(), step=step, chunk=chunk,
            in_chunk=in_chunk, view=view, inplace=inplace, rng=rng,
            group=group, collective=coll, src_dtype=src_dtype, d2h=d2h,
            collides=collides))
        return out

    def record_fetch(self, name: str, t: torch.Tensor) -> None:
        step, chunk, in_chunk = self._where()
        self.ops.append(OpRecord(
            index=len(self.ops), name=f"Tensor.{name}", packet=name, outs=(),
            ins=(_info(t, self.gens),), kernel=_kernel(), step=step,
            chunk=chunk, in_chunk=in_chunk,
            d2h=t.device.type == "cuda"))

    def __enter__(self):
        self._modes = [_FetchMode(self), _DispatchMode(self)]
        for m in self._modes:
            m.__enter__()
        self._prev, Recorder.active = Recorder.active, self
        return self

    def __exit__(self, *exc):
        self._sync_debug(False)
        Recorder.active = self._prev
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


@contextlib.contextmanager
def step(i: int):
    """Mark an engine step for the active recorder (no-op without one)."""
    rec = Recorder.active
    if rec is not None:
        rec.begin_step(i)
    try:
        yield
    finally:
        if rec is not None:
            rec.end_step()


@dataclasses.dataclass
class Trace:
    """One recorded run of an entry, shared by every trace pass."""

    entry: EntryPoint
    ops: list[OpRecord]
    #: storages reachable from the arguments before the run
    arg_storages: set
    #: storages reachable from the returned value
    returned: set
    #: (path -> (storage, shape, placement)) of the carry before and after
    carry_before: dict
    carry_after: dict
    seconds: float = 0.0
    #: kernel launches a wrapper made during the run (CUDA only; the
    #: wrappers' plain versions launch nothing)
    launches: dict = dataclasses.field(default_factory=dict)


def _placement(t: torch.Tensor) -> tuple:
    placements = getattr(t, "placements", None)
    if placements is not None:
        return ("dtensor", tuple(str(p) for p in placements),
                tuple(t.device_mesh.shape))
    return ("device", t.device.type)


def _carry(obj, gens: dict | None = None) -> dict:
    return {path: (_storage_key(t, gens), tuple(t.shape), _placement(t))
            for path, t in reachable_tensors(obj)}


def trace_entry(entry: EntryPoint, *, chunk_steps: int | None = None,
                sync_check: bool = False) -> Trace:
    """Build ``entry`` and run it once under the recorder (with
    ``sync_check``, a host sync inside a chunk raises on the card)."""
    import time

    from repro_torch.kernels.graph_reg import launch_counts

    ctx = entry.context() if entry.context is not None \
        else contextlib.nullcontext()
    with ctx:
        fn, args = entry.build()
        steps = chunk_steps if chunk_steps is not None \
            else getattr(fn, "chunk_steps", 0)
        arg_storages = {_storage_key(t) for _, t in reachable_tensors(args)}
        carry_before = (_carry(args[entry.donate])
                        if entry.donate is not None else {})
        launched = launch_counts()
        t0 = time.perf_counter()
        with Recorder(chunk_steps=steps, sync_check=sync_check) as rec:
            result = fn(*args)
        seconds = time.perf_counter() - t0
        launches = {name: n - launched[name]
                    for name, n in launch_counts().items()
                    if n != launched[name]}
        returned = {_storage_key(t, rec.gens)
                    for _, t in reachable_tensors(result)}
        carry_after = (_carry(args[entry.donate], rec.gens)
                       if entry.donate is not None else {})
        del fn, args, result     # freed before the context closes
    return Trace(entry, rec.ops, arg_storages, returned, carry_before,
                 carry_after, seconds, launches)


def iter_ops(trace: Trace) -> Iterator[tuple[OpRecord, bool]]:
    """Yield ``(op, in_chunk)`` over the recorded ops outside every kernel
    boundary (what a kernel does is what the dense rules must not see)."""
    for op in trace.ops:
        if op.kernel is None:
            yield op, op.in_chunk


def _makes(op: OpRecord) -> bool:
    """Whether an op computes values (not a view or a constant splat)."""
    return not op.view and op.packet not in SPLAT_OPS and bool(op.outs)


def _count_bxb(trace: Trace, B: int) -> int:
    return sum(1 for op, _ in iter_ops(trace) if _makes(op)
               for o in op.outs if o.shape == (B, B) or o.shape[-2:] == (B, B)
               and all(d == 1 for d in o.shape[:-2]))


def count_bxb_intermediates(fn, *args, B: int) -> int:
    """Number of (B, B) outputs made outside kernel boundaries by one run
    of ``fn(*args)``."""
    entry = EntryPoint("count", lambda: (fn, args), B=B)
    return _count_bxb(trace_entry(entry), B)


def audit_entry(entry: EntryPoint, trace: Trace | None = None
                ) -> tuple[list[Finding], dict]:
    """Run ``entry`` (or reuse a shared trace): ``(findings, metrics)``."""
    if trace is None:
        trace = trace_entry(entry)
    findings: list[Finding] = []
    metrics: dict = {"ops": len(trace.ops),
                     "kernel_ops": sum(1 for op in trace.ops if op.kernel),
                     "trace_seconds": trace.seconds}

    # -- J002 / J000: the exact (B, B) counter ---------------------------
    if entry.B is not None:
        n_bxb = _count_bxb(trace, entry.B)
        metrics["bxb_outside_kernels"] = n_bxb
        if entry.expect_bxb is not None and n_bxb > entry.expect_bxb:
            findings.append(Finding(
                "jaxpr", "J002", entry.name,
                f"{n_bxb} (B, B) outputs outside kernel boundaries "
                f"(budget {entry.expect_bxb}, B={entry.B})",
                detail=f"bxb>{entry.expect_bxb}"))
        if entry.canary_min_bxb is not None \
                and n_bxb < entry.canary_min_bxb:
            findings.append(Finding(
                "jaxpr", "J000", entry.name,
                f"reference canary counted only {n_bxb} (B, B) outputs "
                f"(expected >= {entry.canary_min_bxb}) — the counter itself "
                "no longer sees dense intermediates", detail="canary"))

    # -- Per-op rules ----------------------------------------------------
    max_bytes = 0
    dense: dict[str, int] = {}
    promo: dict[str, int] = {}
    syncs: dict[str, int] = {}
    made = {o.storage for op in trace.ops for o in op.outs}
    for op in trace.ops:             # kernel boundaries included
        if op.in_chunk and (op.packet in SYNC_OPS or op.d2h):
            key = "device_to_host" if op.d2h and op.packet not in SYNC_OPS \
                else op.packet
            if op.kernel:
                key = f"{key}@{op.kernel}"
            syncs[key] = syncs.get(key, 0) + 1
    for op, _ in iter_ops(trace):
        if not _makes(op):
            continue
        for o in op.outs:
            nbytes = 1
            for d in o.shape:
                nbytes *= d
            nbytes *= o.dtype.itemsize
            max_bytes = max(max_bytes, nbytes)
            if nbytes >= entry.dense_bytes:
                key = f"{op.packet}:{o.shape}"
                dense[key] = dense.get(key, 0) + 1
            if o.dtype == torch.float64 and not entry.allow_f64:
                promo["float64"] = promo.get("float64", 0) + 1
        if op.src_dtype is not None and entry.compute_dtype and op.outs:
            dst = op.outs[0]
            src = op.src_dtype
            if (str(src).removeprefix("torch.") == entry.compute_dtype
                    and _FLOAT_WIDTH.get(dst.dtype, 0)
                    > _FLOAT_WIDTH.get(src, 9) and len(dst.shape)):
                key = (f"{str(src).removeprefix('torch.')}->"
                       f"{str(dst.dtype).removeprefix('torch.')}")
                promo[key] = promo.get(key, 0) + 1
    metrics["max_intermediate_bytes"] = max_bytes
    metrics["host_syncs_in_chunk"] = sum(syncs.values())
    for key, count in sorted(dense.items()):
        findings.append(Finding(
            "jaxpr", "J001", entry.name,
            f"{count}x dense output {key} >= {entry.dense_bytes} bytes "
            "outside kernel boundaries", detail=key))
    for key, count in sorted(promo.items()):
        findings.append(Finding(
            "jaxpr", "J003", entry.name,
            f"{count}x silent dtype promotion ({key})", detail=key))
    for key, count in sorted(syncs.items()):
        findings.append(Finding(
            "jaxpr", "J004", entry.name,
            f"{count}x host sync '{key}' inside a chunk", detail=key))

    # -- J005: the carry is updated in place -----------------------------
    if entry.donate is not None:
        moved = sorted(path for path, (st, _, _) in trace.carry_before.items()
                       if path in trace.carry_after
                       and trace.carry_after[path][0] != st)
        copies: dict[str, int] = {}
        leaves = {st: (path, shape)
                  for path, (st, shape, _) in trace.carry_before.items()}
        for op in trace.ops:
            if not op.in_chunk or op.view or op.inplace \
                    or op.packet not in ("clone", "_to_copy", "contiguous"):
                continue
            for i in op.ins:
                hit = leaves.get(i.storage)
                if hit and op.outs and op.outs[0].shape == hit[1] \
                        and op.outs[0].storage not in leaves:
                    copies[hit[0]] = copies.get(hit[0], 0) + 1
        metrics["carry_leaves"] = len(trace.carry_before)
        metrics["carry_in_place"] = not moved and not copies
        for path in moved:
            findings.append(Finding(
                "jaxpr", "J005", entry.name,
                f"carry leaf {path} was replaced, not updated in place "
                "(its storage changed over the chunk)",
                detail=f"{path}:storage"))
        for path, n in sorted(copies.items()):
            findings.append(Finding(
                "jaxpr", "J005", entry.name,
                f"{n}x full-size copy of carry leaf {path} inside a chunk",
                detail=f"{path}:copy"))

    # -- J006: captured constants ----------------------------------------
    captured: dict[tuple, TensorInfo] = {}
    for op in trace.ops:
        for i in op.ins:
            if (i.nbytes >= entry.const_bytes
                    and i.storage not in trace.arg_storages
                    and i.storage not in made):
                captured.setdefault(i.storage, i)
    metrics["captured_const_bytes"] = sum(i.nbytes for i in captured.values())
    for i in captured.values():
        findings.append(Finding(
            "jaxpr", "J006", entry.name,
            f"tensor of shape {i.shape} ({i.nbytes} bytes) read by the entry "
            "but neither an argument nor made in it — pass it as an "
            "argument", detail=f"const:{i.shape}"))
    return findings, metrics
