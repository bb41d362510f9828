"""Hopper kernels K12 and K13: the dropless MoE layer's dispatch and
combine, and their wrappers.

``moe_dispatch(x, expert_ids, n_experts)`` (K12) sorts the N·k
assignments of x (N, d) to experts (``expert_ids`` (N, k), token t's
j-th expert is assignment t·k + j) by expert, in assignment order within
an expert, and returns ``(xs, pos, counts, ends)``: the assigned rows of
x in that order (N·k, d), each assignment's row of ``xs`` (N, k) int32,
each expert's rows (E,) int32 and the cumulative ends of their ranges
(E,) int32, the offsets a grouped product takes.  ``moe_combine(out, pos,
weights)`` (K13) sums each token's rows of ``out`` (N·k, d) weighted by
``weights`` (N, k) float32, in float32 in the order j = 0 .. k-1 with
every product and sum rounded, and returns (N, d) in ``out``'s dtype.

CUDA tensors launch ``csrc/moe.cu`` (float32 and bfloat16; rows of a
multiple of 16 bytes, K13 a width that is a multiple of 16 bytes' worth
of its type); CPU tensors run the plain versions
:func:`moe_dispatch_ref` and :func:`moe_combine_ref`, which give the
kernels' bits; mixed devices raise.  A CUDA tensor never reaches the
plain version.  Neither replaces a TPU kernel (the JAX package dispatches
by capacity); the source says what bounds them.  Each wrapper counts its
launches in ``<wrapper>.launches``; :func:`launch_counts` reports them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .boundary import bounded
from .graph_reg import _on_cpu, _raise_on, _stream

__all__ = ["moe_dispatch", "moe_combine", "moe_dispatch_ref",
           "moe_combine_ref", "launch_counts", "reset_launch_counts",
           "occupancy", "OCCUPANCY_KERNELS", "MAX_EXPERTS", "SOURCE"]

SOURCE = "src/repro_torch/csrc/moe.cu"

#: Experts K12 takes (its counts live in shared memory).
MAX_EXPERTS = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "moe_dispatch": (_P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P),
    "moe_combine": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "moe_occupancy": (_I, _I, _I, _P, _P, _P),
}

#: The kernels ``moe_occupancy`` answers for, by index: each one's mangled
#: name from its length on, in the order of the source's ``kOccupancy``.
OCCUPANCY_KERNELS = ("19moe_dispatch_kernelE", "18moe_combine_kernelIf",
                     "18moe_combine_kernelI13__nv_bfloat16")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("moe")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "moe", OCCUPANCY_KERNELS, symbol, threads,
                           dynamic_smem)


def moe_dispatch_ref(x: torch.Tensor, expert_ids: torch.Tensor,
                     n_experts: int):
    """K12's plain version: a stable sort of the assignments by expert
    (on a CUDA tensor nothing waits for the host, so a CUDA graph can hold
    it, as the smoke's timing does)."""
    N, k = expert_ids.shape
    flat = expert_ids.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int32,
                         device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    order = torch.argsort(flat, stable=True)
    pos = torch.empty(N * k, dtype=torch.int32, device=x.device)
    pos[order] = torch.arange(N * k, dtype=torch.int32, device=x.device)
    return (x[order // k], pos.reshape(N, k), counts,
            torch.cumsum(counts, 0, dtype=torch.int32))


def moe_combine_ref(out: torch.Tensor, pos: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """K13's plain version: the weighted rows summed in float32, in order
    j = 0 .. k-1, each product and sum a rounded op of its own."""
    p = pos.long()
    acc = weights[:, 0, None] * out[p[:, 0]].float()
    for j in range(1, pos.shape[1]):
        acc = acc + weights[:, j, None] * out[p[:, j]].float()
    return acc.to(out.dtype)


def _check_rows(t: torch.Tensor, name: str, width: int) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not in {list(_DTYPES)}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (rows, d) matrix, got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")
    if (width * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {width * t.element_size()} bytes "
                         f"at {t.data_ptr():#x}; the kernels move 16-byte "
                         "pieces from 16-byte boundaries")


@bounded("moe_dispatch")
def moe_dispatch(x: torch.Tensor, expert_ids: torch.Tensor, n_experts: int):
    """K12: -> (xs (N·k, d), pos (N, k) int32, counts (E,) int32, ends
    (E,) int32)."""
    if expert_ids.dim() != 2 or x.dim() != 2 or x.shape[0] != \
            expert_ids.shape[0]:
        raise ValueError(f"x must be (N, d) and expert_ids (N, k), got "
                         f"{tuple(x.shape)} and {tuple(expert_ids.shape)}")
    if not 0 < n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch takes 1 to {MAX_EXPERTS} experts, "
                         f"got {n_experts}")
    if _on_cpu(x, expert_ids):
        return moe_dispatch_ref(x, expert_ids, n_experts)
    N, k = expert_ids.shape
    ids = expert_ids.to(torch.int64).contiguous()
    _check_rows(x, "x", x.shape[1])
    xs = torch.empty((N * k, x.shape[1]), dtype=x.dtype, device=x.device)
    pos = torch.empty((N, k), dtype=torch.int32, device=x.device)
    counts = torch.empty(n_experts, dtype=torch.int32, device=x.device)
    ends = torch.empty_like(counts)
    if N == 0:
        return xs, pos, counts.zero_(), ends.zero_()
    rc = _lib().moe_dispatch(ids.data_ptr(), N * k, n_experts, k,
                             x.data_ptr(), x.shape[1] * x.element_size(),
                             xs.data_ptr(), pos.data_ptr(), counts.data_ptr(),
                             ends.data_ptr(), _stream(x))
    _raise_on(rc, "moe_dispatch")
    moe_dispatch.launches += 1
    return xs, pos, counts, ends


@bounded("moe_combine")
def moe_combine(out: torch.Tensor, pos: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """K13: -> (N, d) in ``out``'s dtype."""
    if pos.dim() != 2 or weights.shape != pos.shape or out.dim() != 2:
        raise ValueError(f"out must be (N·k, d), pos and weights (N, k), got "
                         f"{tuple(out.shape)}, {tuple(pos.shape)}, "
                         f"{tuple(weights.shape)}")
    if _on_cpu(out, pos, weights):
        return moe_combine_ref(out, pos, weights)
    N, k = pos.shape
    d = out.shape[1]
    _check_rows(out, "out", d)
    pos = pos.to(torch.int32).contiguous()
    w = weights.to(torch.float32).contiguous()
    y = torch.empty((N, d), dtype=out.dtype, device=out.device)
    if N == 0:
        return y
    rc = _lib().moe_combine(out.data_ptr(), pos.data_ptr(), w.data_ptr(), N,
                            k, d, _DTYPES[out.dtype], y.data_ptr(),
                            _stream(out))
    _raise_on(rc, "moe_combine")
    moe_combine.launches += 1
    return y


WRAPPERS = {"moe_dispatch": moe_dispatch, "moe_combine": moe_combine}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches of K12 and K13 since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
