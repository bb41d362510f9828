"""Flat-npz checkpointing for nests of tensors (the reference's
``repro.train.checkpoint`` on the port's leaves).

A checkpoint is one ``.npz`` of numpy arrays keyed by each leaf's path in
the nest (dict keys and sequence indices joined by ``::``), so it is
stable across process restarts.  Tensors are copied to the host first
(``convert.to_numpy``); Python numbers become 0-d arrays.  Paths are
normalized to exactly one ``.npz`` suffix in both directions, so callers
may pass either a bare path or a ``.npz`` path to either function.

Each leaf's dtype *name* is stored alongside its bytes: numpy serializes
extension dtypes (bfloat16) as raw void records, and the recorded name
lets ``load_checkpoint`` view them back losslessly instead of handing the
caller opaque ``V2`` buffers.

Writes are **atomic**: bytes go to a ``.tmp`` sibling (fsynced) and land
via ``os.replace``, so a crash mid-save leaves the previous checkpoint
intact instead of a torn archive.  Each save also drops a ``.sha256``
sidecar; ``load_checkpoint`` verifies it (and wraps any unreadable
archive) as :class:`CheckpointCorruptError`, which the engine's fallback
path uses to skip to the newest *valid* checkpoint.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from repro_torch.convert import to_numpy

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointCorruptError",
           "atomic_write_text"]


class CheckpointCorruptError(RuntimeError):
    """The archive's bytes do not match its checksum sidecar, or the
    archive cannot be read back into the template at all."""

_SEP = "::"
_DTYPE_PREFIX = "__dtype__" + _SEP


def _norm(path: str) -> str:
    """One ``.npz`` suffix, always — ``np.savez`` appends its own when the
    suffix is missing."""
    return path if path.endswith(".npz") else path + ".npz"


def _leaves_with_path(tree, path=()):
    """``(path, leaf)`` pairs of a nest of dicts, lists and tuples, dict
    keys in sorted order; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(p): np.asarray(to_numpy(leaf))
            for p, leaf in _leaves_with_path(tree)}


def _unflatten(like, leaves: dict):
    """``like``'s nest with each leaf replaced by ``leaves[path]``."""
    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, path + (i,)) for i, v in enumerate(t))
        return None if t is None else leaves[_key(path)]
    return rebuild(like, ())


def _restore_dtype(arr: np.ndarray, name: str) -> np.ndarray:
    if arr.dtype.name == name:
        return arr
    try:
        dt = np.dtype(name)
    except TypeError:
        import ml_dtypes  # registered extension dtypes (bfloat16, fp8, …)
        dt = np.dtype(getattr(ml_dtypes, name))
    # Void records are the same bits under a lost dtype — reinterpret;
    # anything else genuinely changed representation in the archive.
    return arr.view(dt) if arr.dtype.kind == "V" else arr.astype(dt)


def _atomic_write_bytes(path: str, write_fn) -> None:
    """Run ``write_fn(file_object)`` against ``path + ".tmp"`` and publish
    via ``os.replace`` — the file either keeps its old bytes or gets the
    complete new ones, never a torn mix."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Atomic replacement for ``open(path, "w").write(text)`` — used for
    the LATEST pointer and meta sidecars too, not just archives."""
    _atomic_write_bytes(path, lambda f: f.write(text.encode()))


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(path: str, tree, *, checksum: bool = True) -> None:
    path = _norm(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    dtypes = {_DTYPE_PREFIX + k: np.str_(v.dtype.name)
              for k, v in flat.items()}
    # Write through a file object: np.savez would append a second ".npz"
    # to a bare ".tmp" path, desyncing the replace target.
    _atomic_write_bytes(path, lambda f: np.savez(f, **flat, **dtypes))
    if checksum:
        atomic_write_text(path + ".sha256", _digest(path) + "\n")


def load_checkpoint(path: str, like, *, verify: bool = True):
    """Restore into the nest of ``like`` (a template), numpy leaves.

    Leaves keep the dtype they were *saved* with (the template supplies
    structure and expected shapes only) — restoring must not silently cast
    e.g. a uint8 generator state or an int step counter to the template's
    dtype.

    With ``verify=True`` (default) the ``.sha256`` sidecar, when present,
    is checked before the archive is opened; a mismatch — or any failure
    to read the archive back into the template — raises
    :class:`CheckpointCorruptError` so callers can fall back to an older
    checkpoint instead of crashing on a torn file.
    """
    path = _norm(path)
    sidecar = path + ".sha256"
    if verify and os.path.exists(sidecar):
        with open(sidecar) as f:
            expected = f.read().strip()
        actual = _digest(path)
        if actual != expected:
            raise CheckpointCorruptError(
                f"{path}: sha256 mismatch (expected {expected[:12]}…, "
                f"got {actual[:12]}…) — file corrupted after save")
    try:
        data = np.load(path)
        leaves = {}
        for p, leaf in _leaves_with_path(like):
            key = _key(p)
            arr = data[key]
            if _DTYPE_PREFIX + key in data.files:
                arr = _restore_dtype(arr, str(data[_DTYPE_PREFIX + key]))
            assert arr.shape == tuple(np.shape(leaf)), (key, arr.shape,
                                                        np.shape(leaf))
            leaves[key] = arr
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})") from e
    return _unflatten(like, leaves)
