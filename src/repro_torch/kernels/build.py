"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.  The
library's file name carries a hash of the source text, the shared headers
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Builds land in ``<checkout>/build/``
(``REPRO_TORCH_BUILD_DIR`` overrides it); a build writes to a temporary
name and renames it into place, so concurrent first uses in several
processes cannot load a half-written library.

Nothing here runs at import time: machines without ``nvcc`` import every
module, and a build starts only when a CUDA tensor first meets a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "REPORTS", "build_dir", "find_nvcc",
           "library_path", "build", "load", "occupancy"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
#: The compiler's report (``-Xptxas -v``) of each verbose build, by name.
REPORTS: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin); the "
        "Hopper kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on its text, the shared
    headers' (``csrc/*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{key[:16]}.so"


def build(name: str, *, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    ``verbose`` adds ``-Xptxas -v`` and returns with the compiler's report
    printed (registers, shared memory and spills of each kernel) and kept
    in ``REPORTS[name]``.
    """
    out = library_path(name)
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    if verbose:
        REPORTS[name] = proc.stderr
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib


def occupancy(lib: ctypes.CDLL, name: str, kernels: tuple[str, ...],
              symbol: str, threads: int, dynamic_smem: int) -> dict:
    """The runtime's reading of kernel ``symbol`` of library ``name``
    (``<name>_occupancy``, whose table lists ``kernels`` in order) launched
    with ``threads`` threads and ``dynamic_smem`` bytes of dynamic shared
    memory: the blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the kernel's
    registers a thread and static shared memory
    (``cudaFuncGetAttributes``)."""
    blocks, regs, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, f"{name}_occupancy")(
        kernels.index(symbol), threads, dynamic_smem, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(static))
    if rc != 0:
        raise RuntimeError(f"{name}_occupancy({symbol}, {threads} threads, "
                           f"{dynamic_smem} bytes) failed with CUDA error "
                           f"{rc}")
    return {"resident_blocks": blocks.value, "registers": regs.value,
            "static_smem_bytes": static.value}
