"""The ctypes signatures of the port's kernel libraries against their C
sources.

Each wrapper module loads its library with ctypes and declares every entry
point's argument types in ``_SIGNATURES``; ctypes trusts them, so an
argument added to or dropped from a C entry point and not from the table
shifts every later argument of the call.  The card is not needed: the
entry points are read from the ``extern "C"`` blocks of the sources.
"""
import ctypes
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, graph_reg,  # noqa: E402
                                 graph_reg_bsp, moe, norm, pairwise)

ROOT = Path(__file__).resolve().parents[1]
MODULES = (graph_reg, graph_reg_bsp, pairwise, flash_attention, moe, norm)
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int*": ctypes.c_void_p, "int64_t*": ctypes.c_void_p,
           "int": ctypes.c_int,
           "float": ctypes.c_float}


def _entry_points(module) -> dict[str, tuple]:
    """Name -> ctypes argument types of every function defined in the
    ``extern "C"`` blocks of the module's source."""
    src = (ROOT / module.SOURCE).read_text()
    blocks = re.findall(r'extern "C" \{(.*?)\}  // extern "C"', src, re.S)
    found = {}
    for block in blocks:
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block,
                                       re.M):
            types = []
            for param in params.split(","):
                words = param.split()
                types.append(_CTYPES[" ".join(words[:-1])
                                     + ("*" if words[-1][0] == "*" else "")])
            found[name] = tuple(types)
    return found


@pytest.mark.parametrize("module,name", [
    (m, name) for m in MODULES for name in sorted(_entry_points(m))],
    ids=lambda v: v if isinstance(v, str) else v.__name__.rsplit(".", 1)[1])
def test_signature_matches_the_c_entry_point(module, name):
    assert module._SIGNATURES.get(name) == _entry_points(module)[name]


@pytest.mark.parametrize("module", MODULES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_every_declared_signature_is_an_entry_point(module):
    assert set(module._SIGNATURES) == set(_entry_points(module))


_TEMPLATE_ARGS = {"true": "Lb1E", "false": "Lb0E", "float": "f",
                  "__nv_bfloat16": "13__nv_bfloat16"}


def _mangled(spelling: str) -> str:
    """``reg_fwd_partials<true>`` -> ``16reg_fwd_partialsILb1E``: the
    mangled name from its length on, as the compiler's report has it."""
    name, _, targs = spelling.partition("<")
    name = name.rsplit("::", 1)[-1]
    args = [a.strip() for a in targs.rstrip(">").split(",") if a.strip()]
    return f"{len(name)}{name}" + (
        "I" + "".join(_TEMPLATE_ARGS.get(a, f"Li{a}E") for a in args)
        if args else "E")


@pytest.mark.parametrize("module", MODULES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_occupancy_table_matches_the_source(module):
    """``<lib>_occupancy`` answers by index into the source's
    ``kOccupancy`` table; the module's ``OCCUPANCY_KERNELS`` must name the
    same kernels in the same order."""
    src = (ROOT / module.SOURCE).read_text()
    table = re.search(r"const OccupancyQuery kOccupancy\[\] = \{(.*?)\};",
                      src, re.S).group(1)
    spellings = re.findall(r"occupancy<(.+?)>,\n", table)
    assert tuple(_mangled(s) for s in spellings) == module.OCCUPANCY_KERNELS
