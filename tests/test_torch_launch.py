"""The port's launcher against the JAX package's, on the CPU.

* ``input_specs``: the step's arguments (``meta`` tensors) have the
  reference's shapes and dtypes for every arch × input shape (the
  reference's built on a 1 × 1 ``jax.make_mesh``; its ``PRNGKey`` is the
  port's ``torch.Generator``);
* the meta rules of K1, K2 and K11: right shapes and dtypes, no launch, no
  plain version, one operation each with the kernel's FLOP formula;
* trip counting: a 7-step ``chunked_scan`` of 64 × 64 matmuls counts
  exactly 7·2·64³ FLOPs (the reference's
  ``test_hlo_analysis_trip_counting``), and a train step's costs read
  off cut traces and with traced scan steps equal a full trace's;
* the collective model against hand counts (dp and fsdp);
* the dry run: the reference's mini case (qwen1.5-0.5b, decode_32k, a
  4 × 2 mesh, fsdp_tp) and its train_4k step are ``ok`` with FLOPs > 0;
* ``--smoke``: ``smoke(device="cpu")`` for qwen2-1.5b and mixtral-8x7b
  reduced, from the reference's initial params (numpy, copied in by
  ``convert.to_torch``),
  matches the reference's smoke epoch (its engine, its ``lm_train_step``
  with its inline regularizer) on the same batches: the epoch's mean
  ``loss/total`` within rtol 1e-5 (float32, 10 AdaGrad steps).
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.ssl_loss import SSLHyper as JaxHyper  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adagrad as jax_adagrad  # noqa: E402
from repro.optim import constant_lr as jax_constant_lr  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train.train_step import lm_train_step as jax_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import graph_analysis as ga  # noqa: E402
from repro_torch.launch.inputs import input_specs, train_inputs  # noqa: E402
from repro_torch.launch.mesh import debug_mesh, production_mesh  # noqa: E402
from repro_torch.launch.train import smoke  # noqa: E402
from repro_torch.models.layers import scan_utils  # noqa: E402
from repro_torch.models.layers.scan_utils import chunked_scan  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The smokes' tiny eager ops, one intra-op thread each: with the
    suite's workers on every core, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _jax_tree(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in p): (tuple(x.shape), str(x.dtype))
        for p, x in flat}


def _port_tree(tree) -> dict:
    return {p: (tuple(t.shape), _dtype(t.dtype))
            for p, t in specs.tree_paths(tree)}


@functools.cache
def _jax_abstract_params(cfg):
    return _orig_abstract_params(cfg)


_orig_abstract_params = jtf.abstract_params


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape_name, monkeypatch):
    # The reference's params tree per config, drawn once (its inputs
    # draw it anew for each shape).
    monkeypatch.setattr(jtf, "abstract_params",
                        lambda cfg, **kw: _jax_abstract_params(cfg))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jinputs.input_specs(arch, shape_name, mesh, "fsdp_tp")
    got = input_specs(arch, shape_name, production_mesh(), "fsdp_tp")
    assert got["donate"] == want["donate"]
    jargs, targs = want["args"], got["args"]
    if INPUT_SHAPES[shape_name].kind == "decode":
        assert isinstance(targs[-1], torch.Generator)
        jargs, targs = jargs[:-1], targs[:-1]
    assert len(jargs) == len(targs)
    for j, t in zip(jargs, targs):
        assert _port_tree(t) == _jax_tree(j)
    assert list(got["specs"]) == list(
        {"train": ["params", "opt_state", "batch"],
         "prefill": ["params", "batch"],
         "decode": ["params", "cache", "tokens", "pos"]}[
            INPUT_SHAPES[shape_name].kind])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_plain(monkeypatch):
    for name in ("reg_forward_ref", "reg_bwd_dlogp_ref",
                 "flash_attention_ref"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail(
            "a meta input reached the plain version"))


KERNEL_RULES = {
    "graph_reg_fwd": (
        lambda: gr.reg_forward(_meta(16, 16, 151936), _meta(16, 16, 16),
                               1.0, 1e-4, 1.0),
        (16,), torch.float32, gr.reg_forward_flops(16, 16, 151936)),
    "graph_reg_bwd_dlogp": (
        lambda: gr.reg_bwd_dlogp(_meta(16, 16, 151936), _meta(16, 16, 16),
                                 _meta(16), 1.0, 1e-4, 1.0),
        (16, 16, 151936), torch.float32,
        gr.reg_bwd_dlogp_flops(16, 16, 151936)),
    "flash_attention": (
        lambda: fa.flash_attention_gqa(
            _meta(32, 2048, 12, 128, dtype=torch.bfloat16),
            _meta(32, 2048, 2, 128, dtype=torch.bfloat16),
            _meta(32, 2048, 2, 128, dtype=torch.bfloat16)),
        (32, 2048, 12, 128), torch.bfloat16,
        4.0 * 128 * 32 * 12 * (2048 * 2049 // 2)),
}


@pytest.mark.parametrize("name", list(KERNEL_RULES))
def test_kernel_meta_rule_is_one_counted_operation(name, monkeypatch):
    _no_plain(monkeypatch)
    call, shape, dtype, flops = KERNEL_RULES[name]
    gr.reset_launch_counts()
    out = call()
    assert out.device.type == "meta"
    assert tuple(out.shape) == shape and out.dtype == dtype
    costs = ga.analyze_step(call)
    assert costs.kernel_ops == {name: 1.0}
    # K11's wrapper scales q first (one elementwise op, no FLOPs counted).
    assert costs.flops == flops
    assert all(v == 0 for v in gr.launch_counts().values())


def test_trip_counting_of_a_chunked_scan():
    """The reference's test_hlo_analysis_trip_counting: a 7-step scan of
    64 × 64 matmuls is 7·2·64³ FLOPs."""
    x, w = _meta(64, 64), _meta(64, 64)

    def f(x, w):
        return chunked_scan(lambda c, _: (c @ w, c), x, (_meta(7, 1),))[0]

    assert ga.analyze_step(f, x, w).flops == 7 * 2 * 64 ** 3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-1.5-large-398b",
                                  "xlstm-125m"])
def test_traced_loops_count_what_the_full_loops_count(arch, monkeypatch):
    """A train step of 5 scanned super-blocks and T = 8 scan steps:
    ``dryrun.step_costs`` (read off traces of 1, 2 and 3 super-blocks)
    gives a full trace's FLOPs, traffic, ops and kernel operations exactly
    and its peak of live bytes within 15 %; with the scans run step by
    step too, FLOPs and kernel operations stay exact (jamba, xlstm)."""
    cfg = dryrun.with_scanned(get_config(arch).reduced(), 5)
    shape = InputShape("tiny", 8, 8, "train")
    read = dryrun.step_costs(cfg, shape)
    spec = train_inputs(cfg, shape, debug_mesh(), "fsdp")
    full = ga.analyze_step(spec["fn"], *spec["args"])
    assert (read.flops, read.traffic_bytes, read.n_ops, read.kernel_ops) == (
        full.flops, full.traffic_bytes, full.n_ops, full.kernel_ops)
    assert abs(read.peak_live_bytes / full.peak_live_bytes - 1) < 0.15
    assert full.kernel_ops == {"graph_reg_fwd": 1.0,
                               "graph_reg_bwd_dlogp": 1.0}
    monkeypatch.setattr(ga, "_traced_twice", scan_utils._loop)
    spec = train_inputs(cfg, shape, debug_mesh(), "fsdp")
    loops = ga.analyze_step(spec["fn"], *spec["args"])
    assert loops.flops == full.flops > 0
    assert loops.kernel_ops == full.kernel_ops
    assert (loops.n_ops > full.n_ops) == (arch != "qwen2-1.5b")


def test_collective_model_matches_hand_counts():
    cfg = get_config("qwen2-1.5b").reduced()
    spec = train_inputs(cfg, InputShape("tiny", 16, 8, "train"),
                        debug_mesh(), "dp")
    params = spec["args"][0]
    leaves = specs.tree_paths(params)
    nbytes = {p: t.numel() * t.element_size() for p, t in leaves}
    mesh = debug_mesh()                       # data 2, model 2
    kw = dict(train=True, act_tokens=64, d_model=cfg.d_model, act_itemsize=4)
    by, count = ga.collective_costs(
        params, specs.param_shardings(params, mesh, "dp"), mesh, "dp", **kw)
    assert by["all-reduce"] == sum(nbytes.values())
    assert count["all-reduce"] == len(leaves)
    assert sum(by.values()) == by["all-reduce"]
    by, count = ga.collective_costs(
        params, specs.param_shardings(params, mesh, "fsdp"), mesh, "fsdp",
        **kw)
    # By hand: a leaf with a dim of even size (past a stacked leaf's scan
    # dim) is sharded over data: gathered twice and reduce-scattered, each
    # moving the whole leaf; the others have their gradient all-reduced.
    sharded = {p for p, t in leaves
               if any(n % 2 == 0 and n >= 2 for n in
                      t.shape[1 if "superblocks" in p else 0:])}
    assert by["all-gather"] == 2 * sum(nbytes[p] for p in sharded)
    assert by["reduce-scatter"] == sum(nbytes[p] for p in sharded)
    assert by["all-reduce"] == sum(nbytes[p] for p in nbytes
                                   if p not in sharded)
    assert count["all-gather"] == 2 * len(sharded)
    assert count["reduce-scatter"] == len(sharded)


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
def test_mini_dryrun(shape_name):
    """The reference's mini case (qwen1.5-0.5b on a 4 × 2 mesh under
    fsdp_tp), in process: no environment, no process group."""
    mesh = debug_mesh(data=4, model=2)
    rec = dryrun.run_one("qwen1.5-0.5b", shape_name, strategy="fsdp_tp",
                         mesh=mesh)
    assert rec["status"] == "ok", rec
    assert rec["flops_per_chip"] > 0 and rec["chips"] == 8
    assert rec["argument_bytes_per_chip"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert math.isfinite(rec["useful_flops_ratio"])
    if shape_name == "train_4k":
        assert rec["kernel_ops"] == {"graph_reg_fwd": 1.0,
                                     "graph_reg_bwd_dlogp": 1.0}
        assert rec["collectives"]["count_by_op"]["reduce-scatter"] > 0


def _reference_smoke(arch: str, steps: int, scan_chunk: int):
    """The reference's ``launch.train._run_smoke``, as it builds its
    params, batches and engine -> (initial params, epoch mean loss)."""
    cfg = jax_config(arch).reduced()
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    init = jax.device_get(params)
    opt = jax_adagrad()
    hyper = JaxHyper(1e-2, 1e-3, 0.0)
    state = jengine.TrainState.create(params, opt.init(params),
                                      jax.random.PRNGKey(0))
    B, T = 4, 32
    rng = np.random.default_rng(0)
    step_fn = jengine.lift_step(
        lambda p, o, batch, lr: jax_step(p, o, batch, cfg=cfg, hyper=hyper,
                                         opt=opt, lr=lr))

    def epoch():
        for _ in range(steps):
            toks = rng.integers(0, cfg.vocab_size, (B, T + 1),
                                dtype=np.int32)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                     "loss_mask": np.ones((B, T), np.float32),
                     "W": np.ones((1, B, B), np.float32),
                     "seq_labels": np.zeros((1, B), np.int32),
                     "seq_label_mask": np.ones((1, B), np.float32)}
            if cfg.modality_tokens:
                batch["modality_embeds"] = np.zeros(
                    (B, cfg.modality_tokens, cfg.modality_dim), np.float32)
            yield batch

    engine = jengine.Engine(step_fn, strategy="sequential",
                            scan_chunk=scan_chunk, prefetch=2)
    res = engine.run(epoch, state=state, n_epochs=1,
                     lr_schedule=jax_constant_lr(1e-3))
    return init, float(res.history[-1]["loss/total"])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_smoke_matches_the_reference_smoke(arch):
    init, want = _reference_smoke(arch, steps=10, scan_chunk=5)
    steps = []
    res = smoke(arch, steps=10, scan_chunk=5, device="cpu", params=init,
                record=steps)
    got = res.history[-1]["loss/total"]
    assert res.state.step == 10 and len(steps) == 10
    assert all(math.isfinite(float(m["loss/total"])) for m in steps)
    print(f"{arch}: port {got!r}, reference {want!r}, rel "
          f"{abs(got - want) / abs(want):.3e}")
    assert got == pytest.approx(want, rel=1e-5), (got, want)


def test_smoke_draws_its_params_from_the_generator():
    """``smoke(generator=)`` starts from ``init_params`` of that generator:
    the same losses as from those params passed in, bit for bit, and not
    those of the default seed."""
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen2-1.5b").reduced()
    runs = []
    for kw in ({"generator": torch.Generator().manual_seed(3)},
               {"params": tf.init_params(cfg, torch.Generator().manual_seed(3),
                                         device="cpu")},
               {}):
        rec = []
        smoke("qwen2-1.5b", steps=2, scan_chunk=2, device="cpu", record=rec,
              **kw)
        runs.append([float(m["loss/total"]) for m in rec])
    assert runs[0] == runs[1] != runs[2]


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports nothing at the top but the
    standard library)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (arch, the faults planted in the plain K1 / K2 the CPU runs: name ->
#: (K1's factor, K2's factor), the fault the smoke's rule must catch).
PLANTED = {
    "qwen2-1.5b": ({"K1 x 0.9": (0.9, 1.0), "K2 x 0": (1.0, 0.0),
                    "K2 x 10": (1.0, 10.0)}, "K1 x 0.9"),
    "yi-9b": ({"K2 x 0": (1.0, 0.0)}, "K2 x 0"),
    "xlstm-125m": ({"K2 x 0": (1.0, 0.0), "K2 x 100": (1.0, 100.0)},
                   "K2 x 100"),
}


@pytest.mark.parametrize("arch", list(PLANTED))
def test_smoke_loss_rules_against_planted_faults(arch, monkeypatch):
    """The upper readings of ``chip_smoke.py``'s ``--smoke`` loss rules: a
    smoke run on the CPU with the plain K1 or K2 scaled, against the sound
    run, as the card's run is held to the CPU's.  The named fault breaks
    its rule (K1 × 0.9 the first step's, K2 × 0 yi-9b's later steps',
    K2 × 100 the recurrent rule); each fault's readings are printed
    (``-s``), including those the rules do not see."""
    cs = _chip_smoke()
    recurrent = arch == "xlstm-125m"
    rtol = cs.SMOKE_RECURRENT_RTOL if recurrent else cs.SMOKE_RTOL
    faults, caught = PLANTED[arch]
    fwd, bwd = ref.reg_forward_ref, ref.reg_bwd_dlogp_ref

    def losses(k1: float, k2: float) -> list[float]:
        monkeypatch.setattr(ref, "reg_forward_ref",
                            lambda *a, **k: k1 * fwd(*a, **k))
        monkeypatch.setattr(ref, "reg_bwd_dlogp_ref",
                            lambda *a, **k: k2 * bwd(*a, **k))
        rec = []
        smoke(arch, steps=cs.SMOKE_STEPS, device="cpu", record=rec)
        return [float(m["loss/total"]) for m in rec]

    sound = losses(1.0, 1.0)
    for name, factors in faults.items():
        rels = [abs(a - b) / max(1.0, abs(b))
                for a, b in zip(losses(*factors), sound)]
        first, later = rels[0], max(rels[1:])
        print(f"{arch} {name}: first step {first:.3e} (rule "
              f"{cs.SMOKE_FIRST_RTOL:g}), later steps {later:.3e} (rule "
              f"{rtol:g})")
        if name == caught:
            assert first > cs.SMOKE_FIRST_RTOL or later > rtol


def test_recurrent_smoke_amplifies_round_off():
    """Why ``chip_smoke.py`` holds the recurrent families' smoke losses
    (card against CPU) to a looser rule: a 1e-7 relative change of
    xlstm-125m's initial params moves its CPU smoke losses by more than
    1e-4 of themselves within 10 steps (AdaGrad turns gradients at
    round-off level into lr-sized steps), while the first step moves by
    less than 1e-6."""
    from repro_torch.models import transformer as tf
    cfg = get_config("xlstm-125m").reduced()

    def draw():
        return tf.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    moved, gen = draw(), torch.Generator().manual_seed(1)
    for _, t in specs.tree_paths(moved):
        t.mul_(1 + 1e-7 * torch.randn(t.shape, generator=gen))
    runs = []
    for p in (draw(), moved):
        rec = []
        smoke("xlstm-125m", device="cpu", params=p, record=rec)
        runs.append([float(m["loss/total"]) for m in rec])
    rels = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(*runs)]
    print("xlstm-125m smoke, 1e-7 relative change of the params: "
          + ", ".join(f"{r:.2e}" for r in rels))
    assert rels[0] < 1e-6
    assert max(rels) > 1e-4
