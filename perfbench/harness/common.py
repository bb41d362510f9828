"""Pieces both loops use: the program's configuration, the program's
param nest by leaf name, device housekeeping, progress lines and the
per-layer metrics' readers."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

from . import spec

#: Fields of ``repro_torch.models.config.ModelConfig`` that a configuration
#: file states, by the file's key.
SIZES = {"n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
         "n_kv_heads": "n_kv_heads", "head_dim": "hd", "d_ff": "d_ff",
         "vocab_size": "vocab_size", "qkv_bias": "qkv_bias",
         "rope_theta": "rope_theta", "tie_embeddings": "tie_embeddings",
         "dtype": "dtype"}


def check_faults(faults, known) -> None:
    """Refuse a fault name the loop cannot plant."""
    unknown = set(faults) - set(known)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}; known: {known}")


def program_config(c: dict, *, strict: bool):
    """The program's ``ModelConfig`` of configuration ``c``.  ``strict``
    (every benchmark run) takes the program's own config of ``c["arch"]``
    and fails unless it states the file's sizes; otherwise (the CPU tests,
    at reduced sizes) the file's sizes replace the program's."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN
    base = get_config(c["arch"])
    if not strict:
        fields = {f: c[k] for k, f in SIZES.items() if f != "hd"}
        return dataclasses.replace(base, head_dim=c["head_dim"], **fields)
    got = {k: getattr(base, f) for k, f in SIZES.items()}
    want = {k: c[k] for k in SIZES}
    if (got != want or base.block_pattern != (ATTN,) or base.is_moe
            or base.norm != "rmsnorm" or base.activation != "swiglu"):
        raise ValueError(f"{c['arch']}: the program's config {got} is not "
                         f"the configuration file's {want}")
    return base


class Peak:
    """The device's peak allocation, less the bytes that the check keeps:
    outputs held after their request only so that the reference can judge
    them once the window has closed.  A deployment holds no such thing,
    so the peak a run reports leaves them out."""

    def __init__(self, device):
        self.device = device
        self.held = 0
        self.value = 0

    def read(self) -> int:
        """The peak so far, less what was kept while it was reached."""
        import torch
        if self.device.type == "cuda":
            self.value = max(self.value, torch.cuda.max_memory_allocated(
                self.device) - self.held)
        return self.value

    def keep(self, *outputs) -> None:
        """``outputs`` stay on the device from now on for the check."""
        import torch
        self.read()
        self.held += sum(s.nbytes() for s in _storages(outputs).values())
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def _storages(x, out=None) -> dict:
    """data pointer -> storage of every tensor in a nest of dicts, lists,
    tuples and dataclasses."""
    import torch
    out = {} if out is None else out
    if isinstance(x, torch.Tensor):
        s = x.untyped_storage()
        out[s.data_ptr()] = s
    elif isinstance(x, dict):
        for v in x.values():
            _storages(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _storages(v, out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _storages(getattr(x, f.name), out)
    return out


class SetUp:
    """Stamps of the set-up's phases on the host clock, from the process's
    start, so that a run's ``setup_s`` can be split where it moves."""

    def __init__(self, t_process: float):
        self.marks = [("process start", t_process)]

    def mark(self, phase: str) -> None:
        """``phase`` has just ended."""
        self.marks.append((phase, time.perf_counter()))

    def split(self) -> dict:
        """phase -> its seconds, in order."""
        return {name: t - prev for (_, prev), (name, t)
                in zip(self.marks, self.marks[1:])}

    def report(self) -> None:
        log("set-up phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.split().items()))


def log(msg: str) -> None:
    """A progress line on standard error, stamped with the host clock."""
    print(f"[perfbench {time.perf_counter():.3f}] {msg}", file=sys.stderr,
          flush=True)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def flat_leaves(tree) -> dict:
    """name -> leaf of the program's param nest (or of a nest that mirrors
    it, as the optimizer's state does), named as ``inputs.leaf_specs``
    names them."""
    out = {"embed.table": tree["embed"]["table"],
           "final_norm.scale": tree["final_norm"]["scale"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    for group, leaves in tree["superblocks"][0].items():
        for key, leaf in leaves.items():
            out[f"{group}.{key}"] = leaf
    return out


def read_per_layer(cell: spec.Cell, ctx) -> dict:
    """The cell's per-layer metrics that find something to read."""
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
