"""Roofline terms of one step, from its op graph on the ``meta`` device.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  There is no
compiled module to read: :func:`analyze_step` runs the step on ``meta``
tensors (shapes and dtypes, nothing allocated) under a
``TorchDispatchMode`` that sees every aten op, forward and backward, and
the kernels' shape rules (``repro_torch::graph_reg_fwd``,
``repro_torch::graph_reg_bwd_dlogp``, ``repro_torch::flash_attention``),
each one operation:

  * FLOPs:   ``torch.utils.flop_counter``'s registry (matmuls,
             convolutions, attention) plus the kernels' formulas kept beside
             them; elementwise work is not counted, as the reference counts
             only ``dot`` and convolutions;
  * traffic: the input and output bytes of every op that is not a view.
             Eager PyTorch fuses nothing, so every op materialises its
             outputs: the counterpart of the reference's ``_MATERIALIZING``
             set (a kernel's rule counts its inputs plus its outputs, as the
             reference counts a custom-call);
  * trips:   what runs inside :func:`repeat` ``(n)`` is recorded with
             weight n, and so are the backward nodes made there.
             Under an analysis ``scan_utils.chunked_scan`` traces two
             steps of a recurrence, the second inside ``repeat(T − 1)``
             (:func:`_traced_twice`, swapped in through
             ``scan_utils.loop_through``), as the reference multiplies a
             ``while`` body by its ``known_trip_count``.  FLOPs and kernel
             operations are then the full loop's exactly; traffic is
             lower, as the autograd engine's sums of a scanned input's
             gradients between nodes run once, not once per step.  The
             super-blocks are not repeated here: the dry run traces 1, 2
             and 3 of them and reads the full depth off those traces
             (``dryrun.step_costs``);
  * memory:  the peak of the bytes the trace's live tensors hold (each
             non-view output counted from its op until it is freed).

Collectives have no compiler to read them from.  :func:`collective_costs`
derives them from the param specs by this model, in the reference's unit
(bytes a chip moves = max(Σ operand, Σ output) of each collective):

  * ``dp``: one all-reduce of each gradient (the whole leaf);
  * ``fsdp`` / ``fsdp_tp``: a leaf sharded over the data axes is
    all-gathered once in the forward and once in the backward, and its
    gradient reduce-scattered (each the gathered shard's bytes); a leaf
    replicated over the data axes has its gradient all-reduced (its local
    bytes);
  * ``fsdp_tp``: each use of a matrix weight sharded on ``model`` costs one
    all-reduce of the (local tokens, d_model) activation in the model's
    dtype: in the forward for a row-parallel weight (``model`` on a dim
    other than the last: heads of ``wo``, a contracting dim, the vocab of
    the embedding table, or the expert dim, which stands in for the
    dispatch and combine all-to-alls of expert parallelism), in the
    backward for a column-parallel one (``model`` on the last dim); a
    stacked leaf is used once per super-block;
  * serving steps (prefill, decode) have no backward: the forward
    all-gathers and all-reduces only.

Not modelled: the collectives of a sequence-sharded KV cache (long_500k's
softmax reductions), the loss's scalar reductions, recomputation under
remat, and overlap of collectives with compute.  ``bytes_by_op`` and
``count_by_op`` use the reference's five names; a count is one per leaf
(gathers, reductions) or per use (activation all-reduces).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import flop_registry

from repro_torch.models.layers import scan_utils

__all__ = ["COLLECTIVE_OPS", "StepCosts", "analyze_step", "repeat",
           "collective_costs", "roofline_terms"]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_aten = torch.ops.aten
#: Ops that move no bytes: allocations and reinterpretations of a fresh
#: tensor's storage.
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.new_empty,
               _aten.empty_strided, _aten.new_empty_strided,
               _aten._unsafe_view, _aten.lift_fresh}


@dataclasses.dataclass
class StepCosts:
    flops: float
    traffic_bytes: float
    collective_bytes: float
    bytes_by_op: dict
    count_by_op: dict
    kernel_ops: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    n_ops: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Counter(TorchDispatchMode):
    """Records every op it sees, each with the weight of the innermost
    :func:`repeat` (or of the backward node made inside one)."""

    def __init__(self):
        super().__init__()
        self.weights = [1.0]
        self.flops = 0.0
        self.traffic = 0.0
        self.n_ops = 0.0
        self.kernel_ops: dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._ops: dict = {}

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def _op(self, func) -> tuple:
        """(FLOP formula or None, kernel name or None, counts traffic,
        which returns are fresh tensors) of an op, worked out once."""
        if func not in self._ops:
            packet = func._overloadpacket
            returns = func._schema.returns
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in returns)
            self._ops[func] = (
                flop_registry.get(packet),
                packet.__name__ if func.namespace == "repro_torch" else None,
                not view and packet not in _NO_TRAFFIC,
                tuple(r.alias_info is None for r in returns))
        return self._ops[func]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula, kernel, traffic, fresh = self._op(func)
        w = self.weights[-1]
        self.n_ops += w
        if formula is not None:
            self.flops += w * formula(*args, **kwargs, out_val=out)
        if kernel is not None:
            self.kernel_ops[kernel] += w
        outs = _tensors(out)
        if traffic:
            self.traffic += w * (_bytes(_tensors(args))
                                 + _bytes(_tensors(kwargs)) + _bytes(outs))
        for new, t in zip(fresh, outs):
            if new:
                nbytes = t.numel() * t.element_size()
                self.live += nbytes
                weakref.finalize(t, self._freed, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def _active() -> _Counter | None:
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, _Counter)), None)


def _made_since(seq: int, roots) -> list:
    """The autograd nodes reachable from ``roots`` that were made after
    sequence number ``seq`` (gradient accumulators excluded)."""
    found, stack = {}, list(roots)
    while stack:
        node = stack.pop()
        if (node is None or id(node) in found
                or type(node).__name__ == "AccumulateGrad"
                or node._sequence_nr() < seq):
            continue
        found[id(node)] = node
        stack.extend(nxt for nxt, _ in node.next_functions)
    return list(found.values())


class _NodeCollector(torch.overrides.TorchFunctionMode):
    """The autograd nodes of the tensors made inside a :func:`repeat`: the
    roots from which :func:`_made_since` finds all the nodes made there
    (a custom ``Function``'s node is not an op's output here)."""

    def __init__(self):
        super().__init__()
        self.nodes = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.grad_fn is not None:
                self.nodes[id(t.grad_fn)] = t.grad_fn
        return out


@contextlib.contextmanager
def repeat(n: int):
    """Weight what the active :func:`analyze_step` records inside by n:
    the ops run here, and later the backward nodes made here.  Without an
    active analysis it does nothing.

    A backward node's weight holds while it runs (a pre-hook sets it, a
    hook restores it).  A checkpointed region recomputes its forward when
    its first node that needs a saved tensor runs; the port's recurrences
    end in a projection outside the scan, so that node has weight 1."""
    counter = _active()
    if counter is None:
        yield
        return
    weight = counter.weights[-1] * n
    counter.weights.append(weight)
    seq = torch._C._autograd._get_sequence_nr()
    collector = _NodeCollector()
    try:
        with collector:
            yield
    finally:
        counter.weights.pop()

    def enter(grad_outputs):
        # Registered inner scope first: the larger (innermost) weight wins.
        counter.weights.append(max(weight, counter.weights[-1]))

    def leave(grad_inputs, grad_outputs):
        counter.weights.pop()

    for node in _made_since(seq, collector.nodes.values()):
        node.register_prehook(enter)
        node.register_hook(leave)


def _traced_twice(step, init, xs, chunk: int, remat: bool):
    """``chunked_scan``'s loop under an analysis: the first step, then a
    second from its carry standing for steps 2..T inside ``repeat(T −
    1)`` (its backward also carries the gradient to the carry it was
    given, as theirs do), each checkpointed where the loop checkpoints its
    chunks; ys (T, ...) written as the loop's stack writes it."""
    T = xs[0].shape[0]

    def one(carry, t: int):
        if remat:
            return checkpoint(scan_utils._scan, step, carry, xs, t, t + 1,
                              use_reentrant=False)
        return scan_utils._scan(step, carry, xs, t, t + 1)

    carry, y = one(init, 0)
    if T == 1:
        return carry, y
    with repeat(T - 1):
        carry, y2 = one(carry, 1)
    return carry, torch.cat([y, y2.expand(T - 1, *y2.shape[1:])])


def analyze_step(fn, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` (``meta`` tensors) under the counter,
    each recurrence traced by :func:`_traced_twice`: its FLOPs, traffic
    and kernel operations, trip-weighted, and the peak bytes its live
    tensors held.  Collectives are zero here (see
    :func:`collective_costs`)."""
    counter = _Counter()
    with counter, scan_utils.loop_through(_traced_twice):
        fn(*args, **kwargs)
    return StepCosts(
        flops=counter.flops, traffic_bytes=counter.traffic,
        collective_bytes=0.0, bytes_by_op={k: 0.0 for k in COLLECTIVE_OPS},
        count_by_op={k: 0 for k in COLLECTIVE_OPS},
        kernel_ops=dict(counter.kernel_ops), peak_live_bytes=counter.peak,
        n_ops=counter.n_ops)


def _axes_of(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def collective_costs(params, specs: dict, mesh, strategy: str, *,
                     train: bool, act_tokens: int, d_model: int,
                     act_itemsize: int) -> tuple[dict, dict]:
    """``(bytes_by_op, count_by_op)`` a chip moves in one step, by the
    module docstring's model.  ``params`` is the param nest, ``specs``
    their ``{path: spec}`` (``sharding.specs.param_shardings``),
    ``act_tokens`` the tokens a chip holds, ``act_itemsize`` the
    activations' bytes an element."""
    from repro_torch.sharding.specs import (batch_axes, local_shape,
                                            tree_paths)
    by = {k: 0.0 for k in COLLECTIVE_OPS}
    count = {k: 0 for k in COLLECTIVE_OPS}

    def add(op: str, nbytes: float, times: int = 1) -> None:
        by[op] += times * nbytes
        count[op] += times

    data = set(batch_axes(mesh))
    data_n = math.prod(mesh.shape[a] for a in data)
    act = float(act_tokens * d_model * act_itemsize)
    for path, t in tree_paths(params):
        spec = specs[path]
        local = math.prod(local_shape(tuple(t.shape), spec, mesh))
        local *= t.element_size()
        if strategy == "dp":
            if train:
                add("all-reduce", local)
            continue
        axes = [a for entry in spec for a in _axes_of(entry)]
        if data & set(axes):
            gathered = local * data_n
            add("all-gather", gathered, 2 if train else 1)
            if train:
                add("reduce-scatter", gathered)
        elif train:
            add("all-reduce", local)
        if "model" not in axes:
            continue
        stacked = "superblocks" in path
        dims = t.dim() - (1 if stacked else 0)
        if dims < 2:
            continue                  # vectors: elementwise, no reduction
        uses = t.shape[0] if stacked else 1
        model_dim = next(d for d, e in enumerate(spec)
                         if "model" in _axes_of(e))
        if model_dim < t.dim() - 1:
            add("all-reduce", act, uses)          # row-parallel, forward
        elif train:
            add("all-reduce", act, uses)          # column-parallel, backward
    return by, count


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, *, chips: int,
                   peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    """The three §Roofline terms, in seconds (whole-step, all chips).

    flops/bytes are whole-program (all-chips) totals; dividing by
    chips×per-chip-rate gives the balanced per-step time of each resource.
    """
    compute_s = flops / (chips * peak_flops)
    memory_s = bytes_accessed / (chips * hbm_bw)
    collective_s = collective_bytes / (chips * ici_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    return terms
