"""Hopper kernels K1–K3 of the Eq.-3/4 graph regularizer, and their wrappers.

The regularizer over one dense (meta-)batch affinity block is

    L(logp, W) = gc·Σ_ij W_ij·Hc(p_i, p_j) − Σ_i (κ + ge·Σ_j W_ij)·H(p_i)

with Hc(p_i, p_j) = −Σ_c p_ic log p_jc and H(p_i) = −Σ_c p_ic log p_ic; the
scalar triple (gc, κ, ge) is (γ, κ, γ) for the full regularizer and (1, 0, 0)
for the bare cross term.  Each wrapper below launches one kernel of
``csrc/graph_reg.cu`` for CUDA tensors, runs its plain version from
:mod:`repro_torch.kernels.ref` for CPU tensors, and raises for anything
else.  A CUDA tensor never reaches the plain version.

Source notes (P = padded meta-batch, 2176 on the paper's path; C = 39
classes; bounds for one worker on an H100 SXM, 3.35 TB/s and 67 TFLOP/s
f32 without tensor cores):

* ``reg_forward`` — K1, replaces ``repro/kernels/graph_reg.py:
  _fused_reg_forward`` / ``_fused_reg_kernel``.  Reads W once (P²·4 B =
  18.9 MB, 5.7 µs) and does 2·P²·C flops for P·logPᵀ (5.5 µs): bound by
  bytes, barely.  The Pallas kernel added every grid step into one (1,1)
  output, which needs the TPU's ordered grid.  Here each block owns a
  32-row strip, loops over all column tiles and classes itself, and writes
  one partial that already holds its strip's (κ + ge·deg_i)·H_i, since the
  strip holds complete degrees; a second launch sums the partials in strip
  order.  No atomics, so the result is bit-reproducible.
* ``reg_bwd_dlogp`` — K2, replaces ``_reg_bwd_dlogp`` /
  ``_reg_bwd_dlogp_kernel``.  Two products with W (W·logP and Wᵀ·P),
  4·P²·C flops (11 µs): bound by operations.  Each block owns a 32-row
  strip and loops over j; it reads W[i, j] for W·logP and the degrees and
  W[j, i] as a coalesced tile, transposed in shared memory, for Wᵀ·P.  The
  Pallas wrapper's square re-padding of W becomes edge masks.
* ``reg_bwd_dw`` — K3, replaces ``_reg_bwd_dw`` / ``_reg_bwd_dw_kernel``.
  Writes the P×P dW once (18.9 MB, 5.7 µs): bound by bytes.  Output-tiled:
  each block computes its 32×64 tile of P·logPᵀ over all classes and adds
  ge·H_i.  Training never asks for it (W carries no gradient).

All three are plain FMA loops in f32 (no TF32, no tensor cores): the first
aim is agreement with the reference, speed is later work.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

__all__ = ["reg_forward", "reg_bwd_dlogp", "reg_bwd_dw", "launch_counts",
           "reset_launch_counts", "SOURCE"]

SOURCE = "src/repro_torch/csrc/graph_reg.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "graph_reg_fwd_n_partials": (_I, _I),
    "graph_reg_fwd": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P),
    "graph_reg_bwd_dlogp": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P),
    "graph_reg_bwd_dw": (_P, _P, _P, _I, _I, _I, _F, _F, _P, _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("graph_reg")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU inputs, False for all-CUDA ones; raise otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"graph-regularizer kernels take CPU or CUDA tensors, "
                     f"all on one device; got {sorted(kinds)}")


def _checked(t: torch.Tensor, name: str, shape: tuple) -> int:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def _dims(logp: torch.Tensor) -> tuple[int, int, int]:
    if logp.dim() != 3:
        raise ValueError(f"the CUDA kernels take a worker axis: logp must be "
                         f"(k, B, C), got {tuple(logp.shape)}")
    return tuple(logp.shape)


def reg_forward(logp: torch.Tensor, W: torch.Tensor, gc: float, kappa: float,
                ge: float, *, p: torch.Tensor | None = None) -> torch.Tensor:
    """K1: the fused regularizer per worker.  logp (k, B, C), W (k, B, B)
    -> (k,).  ``p`` is ``exp(logp)`` when the caller already has it."""
    if _on_cpu(logp, W):
        return ref.reg_forward_ref(logp, W, gc, kappa, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    partials = torch.empty(_lib().graph_reg_fwd_n_partials(k, B),
                           dtype=torch.float32, device=logp.device)
    out = torch.empty(k, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_fwd(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)), k, B, C, gc, kappa, ge,
        partials.data_ptr(), out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_fwd")
    reg_forward.launches += 1
    return out


def reg_bwd_dlogp(logp: torch.Tensor, W: torch.Tensor, g: torch.Tensor,
                  gc: float, kappa: float, ge: float, *,
                  p: torch.Tensor | None = None) -> torch.Tensor:
    """K2: dL/dlogp, (k, B, C), for the cotangent ``g`` of shape (k,).
    ``g`` stays on the device and the kernel reads it by pointer."""
    if _on_cpu(logp, W, g):
        return ref.reg_bwd_dlogp_ref(logp, W, g, gc, kappa, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    out = torch.empty(k, B, C, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bwd_dlogp(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(W, "W", (k, B, B)), _checked(g, "g", (k,)), k, B, C, gc,
        kappa, ge, out.data_ptr(), _stream(logp))
    _raise_on(rc, "graph_reg_bwd_dlogp")
    reg_bwd_dlogp.launches += 1
    return out


def reg_bwd_dw(logp: torch.Tensor, g: torch.Tensor, gc: float, ge: float, *,
               p: torch.Tensor | None = None) -> torch.Tensor:
    """K3: dL/dW, (k, B, B), for the cotangent ``g`` of shape (k,)."""
    if _on_cpu(logp, g):
        return ref.reg_bwd_dw_ref(logp, g, gc, ge)
    k, B, C = _dims(logp)
    p = torch.exp(logp) if p is None else p
    out = torch.empty(k, B, B, dtype=torch.float32, device=logp.device)
    rc = _lib().graph_reg_bwd_dw(
        _checked(p, "p", (k, B, C)), _checked(logp, "logp", (k, B, C)),
        _checked(g, "g", (k,)), k, B, C, gc, ge, out.data_ptr(),
        _stream(logp))
    _raise_on(rc, "graph_reg_bwd_dw")
    reg_bwd_dw.launches += 1
    return out


_WRAPPERS = {"graph_reg_fwd": reg_forward, "graph_reg_bwd_dlogp": reg_bwd_dlogp,
             "graph_reg_bwd_dw": reg_bwd_dw}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


reset_launch_counts()
