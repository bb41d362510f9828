"""Hopper kernel K14: RMSNorm in one pass, and its wrapper.

``rms_norm(x, scale, eps)`` normalises every row of x (..., d), float32 or
bfloat16, as :func:`repro_torch.models.layers.common.apply_norm` does:
upcast to float32, ``ms = (Σ x²) · (1/d)`` with the float32 1/d,
``r = rsqrt(ms + eps)``, ``(x · r) · scale`` with each product rounded in
float32 in that order, one rounding to x's dtype.  ``scale`` is (d,)
float32.  Only the order of the sum of squares is the kernel's own, so the
kernel and the composite differ by at most a rounding of the output's type
(``tests/test_torch_kernels_cuda.py`` holds the rule).

CUDA tensors launch ``csrc/norm.cu`` (contiguous rows of a multiple of 16
bytes, at most :data:`MAX_D` wide, from a 16-byte boundary, and no input
that requires a gradient: K14 is forward only); anything else raises
(:func:`check_operands`).  CPU tensors run the plain version
:func:`rms_norm_ref`, the composite itself, which ``apply_norm`` calls,
and so do ``meta`` tensors (the dry run traces the composite's ops);
mixed devices raise.  A CUDA tensor never reaches the plain version.  K14
replaces no TPU kernel (the JAX package leaves norms to XLA); the source
says what bounds it.  The serving prefill (``models.transformer.prefill``)
takes it for its RMSNorms; training's ``forward`` and ``decode_step`` keep
the composite.  The wrapper counts its launches in ``rms_norm.launches``;
:func:`launch_counts` reports them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .boundary import bounded
from .graph_reg import _on_cpu, _on_meta, _raise_on, _stream

__all__ = ["rms_norm", "rms_norm_ref", "check_operands", "plan",
           "launch_plan", "rule_readings", "RULE", "launch_counts",
           "reset_launch_counts",
           "occupancy", "OCCUPANCY_KERNELS", "WRAPPERS", "MAX_D", "SOURCE"]

SOURCE = "src/repro_torch/csrc/norm.cu"

#: Widest row K14 takes, in elements (``kMaxD``: eight warps' values).
MAX_D = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Threads a block, values a thread holds at most, warps a row at most
#: (``kThreads``, ``kValues``, ``kMaxWarps`` of the source).
THREADS, VALUES, MAX_WARPS = 256, 32, 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rms_norm_plan": (_I, _I, _I, _P, _P),
    "rms_norm": (_P, _P, _I, _I, _I, ctypes.c_float, _P, _P),
    "norm_occupancy": (_I, _I, _I, _P, _P, _P),
}

#: The kernels ``norm_occupancy`` answers for, by index: each one's mangled
#: name from its length on, in the order of the source's ``kOccupancy``.
OCCUPANCY_KERNELS = tuple(
    f"15rms_norm_kernelI{t}Li{w}E" for t in ("f", "13__nv_bfloat16")
    for w in (1, 2, 4, 8))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("norm")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def occupancy(symbol: str, threads: int, dynamic_smem: int) -> dict:
    """Resident blocks an SM, registers and static shared memory of kernel
    ``symbol`` (:data:`OCCUPANCY_KERNELS`) on the current card, as the
    runtime reads them (builds the library)."""
    return build.occupancy(_lib(), "norm", OCCUPANCY_KERNELS, symbol,
                           threads, dynamic_smem)


def plan(rows: int, d: int, dtype: str) -> dict:
    """K14's launch for ``rows`` rows of ``d`` ``dtype`` ("float32" or
    "bfloat16") values, mirroring the source's ``rms_norm_plan``: the
    fewest warps a row (1, 2, 4 or 8) whose threads hold its d values,
    :data:`VALUES` each, ``THREADS / 32 / warps`` rows a block (the same
    in both dtypes)."""
    warps = next(w for w in (1, 2, 4, 8) if d <= w * 32 * VALUES)
    per = THREADS // 32 // warps
    return {"warps": warps, "rows_per_block": per, "blocks": -(-rows // per),
            "threads": THREADS}


def launch_plan(rows: int, d: int, dtype: str) -> dict:
    """The library's plan (``rms_norm_plan``) of the same launch: warps a
    row and blocks (builds the library)."""
    warps, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _lib().rms_norm_plan(rows, d, _DTYPES[getattr(torch, dtype)],
                              ctypes.byref(warps), ctypes.byref(blocks))
    _raise_on(rc, "rms_norm_plan")
    return {"warps": warps.value, "blocks": blocks.value}


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """K14's plain version: the float32 composite of ``apply_norm``."""
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (nrm * scale).to(x.dtype)


#: The rule K14 is held to against its plain version on the same card
#: tensors (the card tests, ``chip_smoke.norm_kernel_phase``): only the
#: order of the sum of squares differs, so in bfloat16 every element lies
#: within one bfloat16 ulp of the composite's, in float32 within a
#: relative 1e-6 (about 8 ulps); in both K14's worst error against a
#: float64 evaluation is at most the composite's plus one ulp of the type.
RULE = ("bf16: |K14 - composite| <= 1 ulp(composite); f32: |K14 - "
        "composite| <= 1e-6 |composite|; both: max ulps(K14 - f64) <= max "
        "ulps(composite - f64) + 1")
RULE_F32_RTOL = 1e-6


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at each value of ``v`` (float64), the smallest
    normal's below it."""
    fi = torch.finfo(dtype)
    mag = v.abs().clamp_min(fi.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


def rule_readings(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
                  scale: torch.Tensor, eps: float = 1e-6) -> dict:
    """K14's output ``got`` against the composite's ``want`` on the same
    x and scale: the worst distance in ulps of the composite's value and
    relative to it, the share of elements that differ, each one's worst
    error against the float64 evaluation in ulps of the type, and
    ``ok``, whether :data:`RULE` holds."""
    g, w = got.double(), want.double()
    x64 = x.double()
    y64 = x64 * torch.rsqrt(torch.mean(x64 * x64, -1, keepdim=True) + eps) \
        * scale.double()
    diff = (g - w).abs()
    ulps = float((diff / _ulp(w, got.dtype)).max())
    nz = w != 0
    rel = float((diff[nz] / w[nz].abs()).max()) if bool(nz.any()) else 0.0
    exact_zeros = bool((g[~nz] == 0).all())
    unit = _ulp(y64, got.dtype)
    k_err = float(((g - y64).abs() / unit).max())
    c_err = float(((w - y64).abs() / unit).max())
    close = ulps <= 1.0 if got.dtype == torch.bfloat16 else \
        rel <= RULE_F32_RTOL
    return {"ulps": ulps, "rel": rel, "differing": float((g != w).double()
                                                        .mean()),
            "ulps_f64": k_err, "composite_ulps_f64": c_err,
            "ok": close and exact_zeros and k_err <= c_err + 1.0}


def check_operands(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise unless K14 takes x (..., d) and scale (d,): float32 or
    bfloat16 contiguous rows of a multiple of 16 bytes, d at most
    :data:`MAX_D`, from a 16-byte boundary; scale float32 and contiguous;
    neither requiring a gradient."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm: dtype {x.dtype} not in {list(_DTYPES)}")
    if scale.dtype != torch.float32:
        raise TypeError(f"rms_norm: scale must be float32, got {scale.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"rms_norm: x must be (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"rms_norm: x and scale must be contiguous, got "
                         f"strides {x.stride()} and {scale.stride()}")
    if (d * x.element_size()) % 16 or not 0 < d <= MAX_D \
            or x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"rms_norm: rows of {d} values "
                         f"({d * x.element_size()} bytes) at "
                         f"{x.data_ptr():#x}, scale at {scale.data_ptr():#x}; "
                         f"K14 takes up to {MAX_D} values a row, in 16-byte "
                         "pieces from 16-byte boundaries")
    if x.requires_grad or scale.requires_grad:
        raise NotImplementedError(
            "rms_norm (K14) is forward only; a norm that needs a gradient "
            "runs repro_torch.models.layers.common.apply_norm")


@bounded("rms_norm")
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """K14: -> x's shape and dtype."""
    if _on_meta(x, scale) or _on_cpu(x, scale):
        return rms_norm_ref(x, scale, eps)
    check_operands(x, scale)
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return y
    rc = _lib().rms_norm(x.data_ptr(), scale.data_ptr(), rows, d,
                         _DTYPES[x.dtype], eps, y.data_ptr(), _stream(x))
    _raise_on(rc, "rms_norm")
    rms_norm.launches += 1
    return y


WRAPPERS = {"rms_norm": rms_norm}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches of K14 since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
