"""Hopper kernel K11: grouped-query attention forward (flash attention).

``flash_attention_gqa(q, k, v, causal=...)`` takes the reference's layout,
q (B, Tq, H, hd) against k, v (B, Tk, KV, hd), with H a multiple of KV and
query row t at absolute position Tk − Tq + t, and returns (B, Tq, H, hd)
in q's dtype.  It scales q by hd^-0.5 in q's own dtype, as the reference
does before its kernel, then launches ``csrc/flash_attention.cu`` for CUDA
tensors; CPU tensors go to the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref` over the same key
tiles (:func:`block_k`), and mixed devices raise.  A CUDA tensor never
reaches the plain version.

Two routes (:func:`route`): bfloat16 with head dim 64, 112 (kimi-k2's
7168 / 64, in the tile of head dim 128 with its last 16 columns
zero-filled by the TMA) or 128 runs on the tensor cores
(``csrc/flash_attention_wgmma.cuh``: wgmma tiles fed by the TMA, the
softmax in registers, 128-key tiles), and needs every pointer and row
stride on a 16-byte boundary (the TMA's rule); float32, held to atol 3e-5
and so kept off TF32, and bfloat16 with head dim 16 or 32 run a float32
FMA loop over 64-key tiles.  A tensor-core call that cannot build or
launch raises; it never falls back to the FMA kernel.

Source note (bound on an H100 SXM at the serve path's shape, q (4, 2048,
12, 128) and k, v (4, 2048, 2, 128) in bf16, causal): K11 replaces
``repro/kernels/flash_attention.py:flash_attention_fwd_pallas`` /
``_flash_fwd_kernel`` and its GQA wrapper ``flash_attention_gqa_pallas``.
2·B·H·T²·hd = 5.15e10 flops, 0.052 ms at the 989 TFLOP/s bf16
tensor-core peak, against 58.7 MB of q, k, v and o (0.018 ms): bound by
operations, so the serve path's route runs both products on the tensor
cores.  The Pallas grid keeps the online-softmax state in VMEM across an
ordered kv axis; here one block owns a query block of one head (128 rows
on the tensor cores, 64 on the FMA route) and loops over the key tiles
itself, stopping at the diagonal (exact: the tiles past it are no-ops bit
for bit), and reads KV head h // (H / KV) in place of the wrapper's
``jnp.repeat``.

Head dims 16, 32, 64, 112 and 128 and dtypes float32 and bfloat16 are
taken, on both devices; anything else raises.  On ``meta`` tensors (the
dry run) the wrapper scales q as on the card and then takes K11's shape
rule, the custom op ``repro_torch::flash_attention``: an empty ``meta``
output of q's shape and dtype, no launch, no plain version, and the FLOP
formula :func:`flops` (4·hd a kept (query, key) pair, as ``chip_smoke.py``
bounds the kernel).  The wrapper counts its launches in
``flash_attention_gqa.launches``; :func:`repro_torch.kernels.graph_reg.
launch_counts` reports them with the other kernels'.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, ref
from .boundary import bounded
from .graph_reg import _on_cpu, _on_meta, _raise_on, _stream

__all__ = ["flash_attention_gqa", "route", "block_k", "flops", "launch_smem",
           "HEAD_DIMS", "WGMMA_HEAD_DIMS", "WRAPPERS", "OCCUPANCY_KERNELS",
           "occupancy", "SOURCE"]

SOURCE = "src/repro_torch/csrc/flash_attention.cu"

#: Head dims the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Keys per tile of each route (``kBK`` in the sources).
_BLOCK_K = {"wgmma": 128, "fma": 64}


#: Head dims the tensor-core route takes in bfloat16.
WGMMA_HEAD_DIMS = (64, 112, 128)


def route(dtype: torch.dtype, hd: int) -> str:
    """``"wgmma"`` (tensor cores) for bfloat16 at head dim 64, 112 or 128,
    ``"fma"`` for float32 and for bfloat16 at head dim 16 or 32; raises on
    what the kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_gqa: dtype {dtype} not in "
                        f"{list(_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_gqa: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "fma")


def block_k(dtype: torch.dtype, hd: int) -> int:
    """Keys per tile of :func:`route`'s kernel; the CPU path's plain
    version walks the same tiles."""
    return _BLOCK_K[route(dtype, hd)]


def flops(q_shape: tuple, k_shape: tuple, causal: bool) -> float:
    """K11's operations: q·kᵀ and p·v, 4·hd for every (query, key) pair
    the causal mask keeps (query row t at position Tk − Tq + t), all pairs
    without it."""
    B, Tq, H, hd = q_shape
    Tk = k_shape[1]
    pairs = (Tq * (Tk - Tq + 1) + Tq * (Tq - 1) // 2 if causal
             else Tq * Tk)
    return 4.0 * hd * B * H * pairs


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    raise RuntimeError("flash_attention's shape rule runs on meta tensors "
                       "only")


@_flash_attention_rule.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, **_):
    return flops(q_shape, k_shape, causal)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": (_P, _P, _P, _P) + (_I,) * 8 + (_P,),
    "flash_attention_smem": (_I, _I),
    "flash_attention_occupancy": (_I, _I, _I, _P, _P, _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


#: The kernels ``flash_attention_occupancy`` answers for, by index: each one's
#: mangled name from its length on, as the compiler's report names it, in
#: the order of the source's ``kOccupancy`` table.
OCCUPANCY_KERNELS = ("16flash_fwd_kernelIfLi16E",
                     "16flash_fwd_kernelIfLi32E",
                     "22flash_fwd_wgmma_kernelILi64E",
                     "22flash_fwd_wgmma_kernelILi112E",
                     "22flash_fwd_wgmma_kernelILi128E")


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "flash_attention", OCCUPANCY_KERNELS, symbol,
                           threads, dynamic_smem)


def launch_smem(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory (bytes) of one K11 block at ``dtype`` and
    ``hd``, as the library's launch asks for it (builds the library)."""
    route(dtype, hd)
    return _lib().flash_attention_smem(hd, _DTYPES[dtype])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Tq, H, hd) and k, v (B, Tk, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    Bk, Tk, KV, hdk = k.shape
    if Bk != B or hdk != hd or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch "
                         f"and head dim must match and H a multiple of KV")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    route(q.dtype, hd)  # raises on a dtype or head dim the kernel lacks
    if causal and Tq > Tk:
        raise ValueError(f"causal attention needs Tq <= Tk, got Tq={Tq}, "
                         f"Tk={Tk}")


def _check_tma(**tensors: torch.Tensor) -> None:
    """The TMA reads from 16-byte boundaries: every pointer and row stride
    a multiple of 16 bytes."""
    for name, t in tensors.items():
        strides = [st * t.element_size() for st in t.stride()[:-1]]
        if t.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(
                f"flash_attention_gqa: {name} must start on a 16-byte "
                f"boundary with row strides a multiple of 16 bytes for the "
                f"tensor-core route, got address {t.data_ptr():#x} and "
                f"strides {strides} bytes")


@bounded("flash_attention")
def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """K11: softmax(q·kᵀ/√hd)·v per head, causal by absolute position."""
    _check(q, k, v, causal)
    B, Tq, H, hd = q.shape
    if _on_meta(q, k, v):
        return _flash_attention_rule(ref.scale_queries(q), k, v, causal)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       block_k=block_k(q.dtype, hd))
    Tk, KV = k.shape[1], k.shape[2]
    qs = ref.scale_queries(q).contiguous()
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(qs)
    if B == 0 or Tq == 0:
        return out
    if route(q.dtype, hd) == "wgmma":
        _check_tma(qs=qs, k=k, v=v, out=out)
    rc = _lib().flash_attention_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
        H, KV, hd, int(causal), _DTYPES[q.dtype], _stream(q))
    _raise_on(rc, "flash_attention_fwd")
    flash_attention_gqa.launches += 1
    return out


WRAPPERS = {"flash_attention": flash_attention_gqa}
for _fn in WRAPPERS.values():
    _fn.launches = 0
