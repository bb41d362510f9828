"""The port's sharding rules against the JAX package's, on the CPU.

``repro_torch.sharding.specs`` copies the reference's rules; these tests
hold it to them on the reference's meshes (a ``_FakeMesh`` of the
production shapes: the rules read only ``shape`` and ``axis_names``):

* every leaf of every architecture's full-width param tree (the
  reference's ``abstract_params`` against the port's, on ``meta``) under
  dp, fsdp and fsdp_tp on the single and the multi-pod mesh;
* every cache leaf at decode_32k and long_500k, against the reference's
  ``spec_for_cache`` called with the leaf's bare field name;
* the reference's own rule cases (``tests/test_sharding_and_launch.py``);
* the DTensor placements: on a fake process group of 256 and 512 ranks,
  ``compute_local_shape_and_global_offset`` of ``to_placements(spec)``
  equals ``local_shape`` for every leaf of qwen2-1.5b and kimi-k2;
* the reference's cache-path fault: its tree walker names a dataclass
  field ``.k``, so its cache leaf rules never fire on a real cache tree,
  while the port's walker names it ``k``.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import config_for_shape as jax_for_shape  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import config_for_shape  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, production_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": _FakeMesh({"data": 16, "model": 16}),
          "multi": _FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _bare(key) -> str:
    """A jax path entry by its bare name: dict key, list index or
    dataclass field (``GetAttrKey.name``)."""
    for attr in ("key", "idx", "name"):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    return str(key)


def _jax_leaves(tree, bare: bool = True) -> dict:
    """{path: shape} of a reference tree; ``bare=False`` names paths as
    the reference's own walker does."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    name = (lambda p: "/".join(_bare(k) for k in p)) if bare else \
        jspecs._path_str
    return {name(p): tuple(leaf.shape) for p, leaf in flat}


@functools.cache
def _jax_params(arch: str) -> dict:
    return _jax_leaves(jtf.abstract_params(jax_config(arch)))


@functools.cache
def _params(arch: str) -> dict:
    return tf.abstract_params(get_config(arch))


def _norm(spec):
    """Spec equality ignoring trailing Nones (the reference's test's)."""
    t = tuple(spec)
    while t and t[-1] is None:
        t = t[:-1]
    return t


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", specs.STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, strategy, mesh):
    m = MESHES[mesh]
    want = {path: tuple(jspecs.spec_for_param(path, shape, m, strategy))
            for path, shape in _jax_params(arch).items()}
    params = _params(arch)
    got = {path: tuple(spec) for path, spec in
           specs.param_shardings(params, m, strategy).items()}
    shapes = {path: tuple(t.shape) for path, t in specs.tree_paths(params)}
    assert shapes == _jax_params(arch)
    assert got == want
    if strategy == "dp":
        assert all(not any(s) for s in got.values())


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference_rule_on_bare_names(arch,
                                                            shape_name):
    shape = INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    jcfg = jax_for_shape(jax_config(arch), shape)
    want_shapes = _jax_leaves(jax.eval_shape(
        lambda: jtf.init_cache(jcfg, B, S)))
    cache = tf.init_cache(config_for_shape(get_config(arch), shape), B, S,
                          device="meta")
    assert {p: tuple(t.shape) for p, t in specs.tree_paths(cache)} == \
        want_shapes
    for m in MESHES.values():
        for strategy in specs.STRATEGIES:
            want = {p: tuple(jspecs.spec_for_cache(p, s, m, B, strategy))
                    for p, s in want_shapes.items()}
            got = {p: tuple(s) for p, s in specs.cache_shardings(
                cache, m, B, strategy).items()}
            assert got == want, (m.shape, strategy)


# The reference's rule cases (tests/test_sharding_and_launch.py:32-83),
# each (rule, path, shape, mesh, strategy, expected spec without trailing
# Nones); None as the expected value checks only that dim 1 is not on
# 'model' (its MoE case with 8 experts).
MESH, MESH_MP = MESHES["single"], MESHES["multi"]
REFERENCE_CASES = {
    "dp_replicates_everything": [
        ("param", "embed/table", (151936, 1536), MESH, "dp", ()),
        ("param", "superblocks/0/attn/wq", (28, 1536, 12, 128), MESH, "dp",
         ()),
    ],
    "fsdp_shards_largest_divisible_dim": [
        ("param", "embed/table", (151936, 1536), MESH, "fsdp", ("data",)),
        ("param", "superblocks/0/mlp/wu", (28, 1536, 8960), MESH, "fsdp",
         (None, None, "data")),
        ("param", "x/odd", (7, 13), MESH, "fsdp", ()),
    ],
    "fsdp_tp_assigns_model_axis_by_name": [
        ("param", "superblocks/0/mlp/wu", (28, 1536, 8960), MESH, "fsdp_tp",
         (None, "data", "model")),
        ("param", "superblocks/0/moe/wu", (32, 8, 4096, 14336), MESH,
         "fsdp_tp", None),
        ("param", "superblocks/0/moe/wu", (60, 384, 7168, 2048), MESH,
         "fsdp_tp", (None, "model", "data")),
        ("param", "lm_head", (4096, 64000), MESH, "fsdp_tp",
         ("data", "model")),
        ("param", "superblocks/0/attn/wq", (48, 4096, 32, 128), MESH,
         "fsdp_tp", (None, "data", "model")),
    ],
    "multipod_fsdp_uses_pod_and_data": [
        ("param", "embed/table", (151936, 1536), MESH_MP, "fsdp_tp",
         ("model", ("pod", "data"))),
        ("param", "superblocks/0/mlp/wu", (28, 1536, 8960), MESH_MP,
         "fsdp_tp", (None, ("pod", "data"), "model")),
    ],
    "cache_specs_batch_vs_sequence_sharding": [
        ("cache", "layers/0/k", (32, 128, 32768, 8, 128), MESH, 128,
         (None, "data")),
        ("cache", "layers/0/k", (32, 1, 524288, 8, 128), MESH, 1,
         (None, None, "data")),
    ],
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_rule_cases(case):
    for rule, path, shape, mesh, arg, want in REFERENCE_CASES[case]:
        if rule == "param":
            got = specs.spec_for_param(path, shape, mesh, arg)
            ref = jspecs.spec_for_param(path, shape, mesh, arg)
        else:
            got = specs.spec_for_cache(path, shape, mesh, arg, "fsdp_tp")
            ref = jspecs.spec_for_cache(path, shape, mesh, arg, "fsdp_tp")
        assert tuple(got) == tuple(ref), (path, shape)
        if want is None:
            assert got[1] is None
        elif rule == "cache":
            assert _norm(got)[:len(want)] == want
        else:
            assert _norm(got) == want


def test_reference_cache_leaf_rules_never_fire_on_dataclass_paths():
    """The reference names a registered dataclass field ``.k``, so at
    long_500k its tree walker leaves qwen2-1.5b's KV cache replicated;
    the port's walker names it ``k`` and shards the sequence over data,
    the sequence-parallel decode the rule's docstring promises."""
    shape = INPUT_SHAPES["long_500k"]
    B, S = shape.global_batch, shape.seq_len
    jcfg = jax_for_shape(jax_config("qwen2-1.5b"), shape)
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S))
    ref_paths = _jax_leaves(jcache, bare=False)
    assert "layers/0/.k" in ref_paths
    kshape = ref_paths["layers/0/.k"]
    ref = jspecs.spec_for_cache("layers/0/.k", kshape, MESH, B, "fsdp_tp")
    assert all(entry is None for entry in ref)
    cache = tf.init_cache(config_for_shape(get_config("qwen2-1.5b"), shape),
                          B, S, device="meta")
    got = specs.cache_shardings(cache, MESH, B, "fsdp_tp")["layers/0/k"]
    assert tuple(got)[:3] == (None, None, "data")


def test_local_shape_and_placements_by_hand():
    mesh = production_mesh(multi_pod=True)
    spec = specs.PartitionSpec("model", ("pod", "data"))
    assert specs.local_shape((151936, 1536), spec, mesh) == (9496, 48)
    kinds = [type(p).__name__ for p in specs.to_placements(spec, mesh)]
    dims = [getattr(p, "dim", None) for p in specs.to_placements(spec, mesh)]
    assert kinds == ["Shard", "Shard", "Shard"] and dims == [1, 1, 0]
    assert [type(p).__name__ for p in specs.to_placements(
        specs.PartitionSpec(None, "data"), production_mesh())] == \
        ["Shard", "Replicate"]


_PLACEMENTS = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (AbstractMesh, make_device_mesh,
                                         production_mesh)
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import specs

    multi = sys.argv[1] == "multi"
    want = production_mesh(multi_pod=multi)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=want.size)
    dm = make_device_mesh(tuple(want.shape.values()), want.axis_names,
                          "cpu")
    mesh = AbstractMesh.of(dm)
    assert mesh == want, (mesh, want)
    n = bad = 0
    for arch in ("qwen2-1.5b", "kimi-k2-1t-a32b"):
        params = tf.abstract_params(get_config(arch))
        shapes = {p: tuple(t.shape) for p, t in specs.tree_paths(params)}
        for strategy in specs.STRATEGIES:
            for path, spec in specs.param_shardings(
                    params, mesh, strategy).items():
                shape = shapes[path]
                got = tuple(compute_local_shape_and_global_offset(
                    shape, dm, specs.to_placements(spec, mesh))[0])
                n += 1
                if got != specs.local_shape(shape, spec, mesh):
                    bad += 1
                    print("MISMATCH", arch, strategy, path, shape, spec,
                          got, file=sys.stderr)
    dist.destroy_process_group()
    print(json.dumps({"leaves": n, "bad": bad}))
""")


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_placements_give_local_shape_on_a_fake_process_group(mesh):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PLACEMENTS, mesh], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert res["leaves"] > 0 and res["bad"] == 0, out.stderr[-3000:]


def test_abstract_mesh_of_production_shapes():
    single, multi = production_mesh(), production_mesh(multi_pod=True)
    assert (single.size, multi.size) == (256, 512)
    assert single == AbstractMesh({"data": 16, "model": 16},
                                  ("data", "model"))
    assert multi.axis_names == ("pod", "data", "model")
