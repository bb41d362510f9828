"""The port's resilience layer against the reference's.

Mirrors ``tests/test_resilience.py`` and the checkpoint tests of
``tests/test_engine.py``: the fault plan and injector (a copy of the
reference's module, held to it here as well as by its source in
``test_torch_pipeline.py``), the non-finite guard, checkpoint integrity and
retention, resume, and the supervised staging.  Training runs use the
port's copies of the corpus, graph and plan (bit-identical to the
reference's) with dropout 0 and the reference's initial params where the
two packages are compared; their params are held to atol 1e-6 (they
differ by 6e-8 at most: float32 sums in other orders).  Within the port,
a resumed or guard-replayed run must equal the uninterrupted or clean one
bit for bit.
"""
import os
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.resilience as jres  # noqa: E402
from repro.core.ssl_loss import SSLHyper as JHyper  # noqa: E402
from repro.data.pipeline import MetaBatchPipeline as JPipeline  # noqa: E402
from repro.models.dnn import DNNConfig as JDNN  # noqa: E402
from repro.models.dnn import init_dnn as jinit  # noqa: E402
from repro.train import train_dnn_ssl as jtrain  # noqa: E402
import repro.api.config as jconfig  # noqa: E402
import repro_torch.resilience as tres  # noqa: E402
from repro_torch.api.config import ResilienceConfig  # noqa: E402
from repro_torch.convert import to_numpy  # noqa: E402
from repro_torch.core import build_affinity_graph, plan_meta_batches  # noqa: E402
from repro_torch.core.ssl_loss import SSLHyper, tree_leaves  # noqa: E402
from repro_torch.data import drop_labels, make_corpus  # noqa: E402
from repro_torch.data.pipeline import MetaBatchPipeline  # noqa: E402
from repro_torch.models.dnn import DNNConfig  # noqa: E402
from repro_torch.resilience import (FaultEvent, FaultInjector, FaultPlan,  # noqa: E402
                                    InjectedFault, NonFiniteHaltError,
                                    all_finite, guard_init)
from repro_torch.train import train_dnn_ssl  # noqa: E402
from repro_torch.train.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                          _atomic_write_bytes,
                                          atomic_write_text,
                                          load_checkpoint, save_checkpoint)

MODEL = dict(input_dim=24, hidden_dim=32, n_hidden=2, n_classes=6,
             dropout=0.0)
CFG = DNNConfig(**MODEL)
HYPER = dict(gamma=0.3, kappa=1e-4, weight_decay=1e-5)
PARAMS_ATOL = 1e-6


@pytest.fixture(scope="module")
def small_setup():
    corpus = make_corpus(300, n_classes=6, input_dim=24, manifold_dim=4,
                         seed=0)
    labeled = drop_labels(corpus, 0.2, seed=1)
    graph = build_affinity_graph(corpus.X, k=8)
    plan = plan_meta_batches(graph, batch_size=64, n_classes=6, seed=0)
    init = jax.device_get(jinit(JDNN(**MODEL), jax.random.PRNGKey(5)))
    return labeled, graph, plan, init


def pipeline_of(setup, cls=MetaBatchPipeline):
    labeled, graph, plan, _ = setup
    return cls(labeled, graph, plan, n_workers=1, seed=0).epoch


def run(setup, *, n_epochs=2, dropout=0.0, **kw):
    return train_dnn_ssl(pipeline_of(setup), cfg=CFG, hyper=SSLHyper(**HYPER),
                         n_epochs=n_epochs, dropout=dropout, base_lr=5e-3,
                         seed=0, params=setup[3], device="cpu", **kw)


def leaves(res):
    return [np.asarray(x) for x in tree_leaves(to_numpy(res.params))]


def same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def rows(history):
    """History rows without the wall time."""
    return [{k: v for k, v in r.items() if k != "seconds"} for r in history]


def guard(**kw):
    return ResilienceConfig(nonfinite_guard=True, **kw)


# ------------------------------------------------------------ fault plans
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_matches_reference_and_is_pure(seed):
    kw = dict(n_epochs=4, steps_per_epoch=10)
    plan = FaultPlan.from_seed(seed, **kw)
    assert plan == FaultPlan.from_seed(seed, **kw)
    assert plan.to_json() == jres.FaultPlan.from_seed(seed, **kw).to_json()
    assert {e.site for e in plan.events} == {"batch", "prefetch", "replan",
                                             "checkpoint", "worker"}
    assert all(e.epoch >= 1 for e in plan.for_site("checkpoint"))


def test_injector_rejects_colliding_plan_and_fires_once():
    ev = FaultEvent("replan", epoch=1, mode="fail")
    with pytest.raises(ValueError, match="colliding"):
        FaultInjector(FaultPlan(events=(ev, ev)))
    inj = FaultInjector(FaultPlan(events=(ev,)))
    with pytest.raises(InjectedFault):
        inj.maybe_fail("replan", epoch=1)
    inj.maybe_fail("replan", epoch=1)          # consumed — no re-fire
    assert [f["site"] for f in inj.fired()] == ["replan"]
    assert inj.pending() == []


@pytest.mark.parametrize("mode,bad", [("nan", np.isnan), ("inf", np.isinf)])
def test_on_batch_poisons_the_planned_step_only(mode, bad):
    batch = {"x": np.ones((4, 3), np.float32), "valid": np.ones(4, bool)}
    outs = []
    for pkg in (jres, tres):
        inj = pkg.FaultInjector(pkg.FaultPlan(events=(
            pkg.FaultEvent("batch", epoch=0, step=1, mode=mode),)))
        clean = inj.on_batch(batch, epoch=0, step=0)
        assert np.array_equal(clean["x"], batch["x"])
        outs.append(inj.on_batch(batch, epoch=0, step=1))
    assert bad(outs[1]["x"]).all() and np.isfinite(batch["x"]).all()
    np.testing.assert_array_equal(outs[0]["x"], outs[1]["x"])
    np.testing.assert_array_equal(outs[0]["valid"], outs[1]["valid"])


def test_wrap_put_crashes_once_then_keeps_chunk_coordinates():
    inj = FaultInjector(FaultPlan(events=(
        FaultEvent("prefetch", epoch=0, step=1, mode="crash"),
        FaultEvent("prefetch", epoch=0, step=2, mode="crash"),)))
    seen = []
    put = inj.wrap_put(seen.append, epoch=0)
    put("c0")
    with pytest.raises(InjectedFault):
        put("c1")
    put("c1")
    with pytest.raises(InjectedFault):
        put("c2")
    put("c2")
    assert seen == ["c0", "c1", "c2"]


def test_worker_events_stay_pending_under_the_sequential_engine(
        small_setup):
    """``before_chunk`` acts only on strategies with ``bump_age``: the
    port's sequential engine leaves a worker event armed, as the
    reference's sequential strategy does."""
    ev = FaultEvent("worker", epoch=0, step=0, mode="dead")
    inj = FaultInjector(FaultPlan(events=(ev,)))
    res = run(small_setup, n_epochs=1, injector=inj)
    assert inj.pending() == [ev] and inj.fired() == []
    assert same(res, run(small_setup, n_epochs=1))


# ------------------------------------------------------- non-finite guard
def test_all_finite_skips_integer_leaves():
    assert bool(all_finite({"i": torch.arange(3), "x": torch.ones(2)}))
    assert not bool(all_finite({"i": torch.arange(3),
                                "x": torch.tensor([1.0, float("nan")])}))
    assert bool(all_finite({"i": torch.arange(3), "n": 4}))
    assert not bool(all_finite([torch.ones(2), np.array([np.inf])]))
    skipped, consec, worst, tainted = guard_init()
    assert [int(v) for v in (skipped, consec, worst)] == [0, 0, 0]
    assert tainted.dtype == torch.bool and not bool(tainted)


POISON = (FaultEvent("batch", epoch=0, step=1, mode="nan"),
          FaultEvent("batch", epoch=1, step=0, mode="inf"))


def test_guard_skips_exactly_the_poisoned_steps_as_the_reference(
        small_setup):
    """A NaN batch in epoch 0 and an inf batch in epoch 1: both packages
    skip exactly those steps, and the port's params equal the
    reference's."""
    res = run(small_setup, resilience=guard(),
              injector=FaultInjector(FaultPlan(POISON)))
    assert [h["guard/skipped_total"] for h in res.history] == [1, 2]
    assert all(np.isfinite(x).all() for x in leaves(res))
    jout = jtrain(pipeline_of(small_setup, JPipeline), cfg=JDNN(**MODEL),
                  hyper=JHyper(**HYPER), n_epochs=2, dropout=0.0,
                  base_lr=5e-3, seed=0, pairwise="ref", scan_chunk=2,
                  params=small_setup[3],
                  resilience=jconfig.ResilienceConfig(nonfinite_guard=True),
                  injector=jres.FaultInjector(jres.FaultPlan(tuple(
                      jres.FaultEvent(e.site, epoch=e.epoch, step=e.step,
                                      mode=e.mode) for e in POISON))))
    assert [h["guard/skipped_total"] for h in jout.history] == [1, 2]
    for t, j in zip(leaves(res), jax.tree.leaves(jax.device_get(
            jout.params))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                   atol=PARAMS_ATOL)
    for trow, jrow in zip(res.history, jout.history):
        assert set(trow) == set(jrow)
        np.testing.assert_allclose(trow["loss/total"], jrow["loss/total"],
                                   rtol=1e-5)
        assert trow["guard/skipped"] == jrow["guard/skipped"]


@pytest.mark.parametrize("window", [1, 2, 3, 8])
def test_guard_window_changes_no_bit(small_setup, window):
    """A window is a batching of the finiteness fetch, not a semantic: any
    ``guard_window`` gives the same params and history as the default, and
    a clean run through the guard equals an unguarded one."""
    want = run(small_setup, resilience=guard(),
               injector=FaultInjector(FaultPlan(POISON)))
    got = run(small_setup, resilience=guard(guard_window=window),
              injector=FaultInjector(FaultPlan(POISON)))
    assert same(got, want) and rows(got.history) == rows(want.history)
    clean = run(small_setup, resilience=guard(guard_window=window))
    plain = run(small_setup)
    assert same(clean, plain)
    assert [r["loss/total"] for r in clean.history] == \
        [r["loss/total"] for r in plain.history]


def test_guarded_replay_restores_the_dropout_generator(small_setup):
    """With dropout, the poisoned step's draw is undone: the guarded run
    is bit-reproducible and its params stay finite."""
    a = run(small_setup, dropout=0.2, resilience=guard(),
            injector=FaultInjector(FaultPlan(POISON)))
    b = run(small_setup, dropout=0.2, resilience=guard(),
            injector=FaultInjector(FaultPlan(POISON)))
    assert same(a, b) and rows(a.history) == rows(b.history)
    assert all(np.isfinite(x).all() for x in leaves(a))


def test_without_guard_a_poisoned_batch_corrupts_params(small_setup):
    res = run(small_setup, n_epochs=1, resilience=ResilienceConfig(),
              injector=FaultInjector(FaultPlan(POISON[:1])))
    assert not all(np.isfinite(x).all() for x in leaves(res))


def test_halt_after_consecutive_nonfinite_steps(small_setup):
    events = tuple(FaultEvent("batch", epoch=0, step=s, mode="nan")
                   for s in (0, 1, 2))
    with pytest.raises(NonFiniteHaltError, match="3 consecutive"):
        run(small_setup, n_epochs=1,
            resilience=guard(halt_after_consecutive=3),
            injector=FaultInjector(FaultPlan(events)))
    # Two in a row stay under the limit.
    res = run(small_setup, n_epochs=1,
              resilience=guard(halt_after_consecutive=3),
              injector=FaultInjector(FaultPlan(events[:2])))
    assert res.history[0]["guard/skipped_total"] == 2


# ------------------------------------------------- checkpoint integrity
def test_atomic_write_survives_a_mid_write_crash(tmp_path):
    path = str(tmp_path / "LATEST")
    atomic_write_text(path, "ckpt_00001")

    def torn(f):
        f.write(b"ckpt_000")
        raise OSError("disk pulled")

    with pytest.raises(OSError, match="disk pulled"):
        _atomic_write_bytes(path, torn)
    with open(path) as f:
        assert f.read() == "ckpt_00001"
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("corrupt", ["truncate", "bitflip"])
def test_checksum_catches_corruption(tmp_path, corrupt):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "gen": torch.Generator().manual_seed(3).get_state(),
            "step": 7, "opt": [np.int32(2), np.ones(2, np.float64)]}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree)
    assert os.path.exists(path + ".npz.sha256")
    loaded = load_checkpoint(path, tree)
    assert np.array_equal(loaded["w"], tree["w"].numpy())
    assert loaded["gen"].dtype == np.uint8 and loaded["step"] == 7
    assert loaded["opt"][0].dtype == np.int32
    assert loaded["opt"][1].dtype == np.float64
    size = os.path.getsize(path + ".npz")
    if corrupt == "truncate":
        os.truncate(path + ".npz", size // 2)
    else:
        with open(path + ".npz", "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="sha256 mismatch"):
        load_checkpoint(path, tree)


def test_unreadable_archive_is_wrapped_even_without_sidecar(tmp_path):
    tree = {"w": torch.ones(3)}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree, checksum=False)
    assert not os.path.exists(path + ".npz.sha256")
    os.truncate(path + ".npz", 4)
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        load_checkpoint(path, tree)


def test_keep_last_prunes_old_checkpoints(small_setup, tmp_path):
    run(small_setup, n_epochs=3, checkpoint_every=1,
        checkpoint_dir=str(tmp_path), resilience=ResilienceConfig(keep_last=2))
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert names == ["ckpt_00002.npz", "ckpt_00003.npz"]
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.endswith(".sha256")) == ["ckpt_00002.npz.sha256",
                                                "ckpt_00003.npz.sha256"]
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "ckpt_00003"


# ---------------------------------------------------------------- resume
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_resume_matches_uninterrupted_bit_for_bit(small_setup, tmp_path,
                                                  dropout):
    """Stop after epoch 2 of 4 and resume: params, AdaGrad state, the
    dropout generator's state, the step and the history rows equal the
    uninterrupted run's."""
    full = run(small_setup, n_epochs=4, dropout=dropout)
    run(small_setup, n_epochs=2, dropout=dropout, checkpoint_every=1,
        checkpoint_dir=str(tmp_path))
    resumed = run(small_setup, n_epochs=4, dropout=dropout,
                  checkpoint_every=1, checkpoint_dir=str(tmp_path),
                  resume=True)
    assert same(resumed, full)
    for a, b in zip(tree_leaves(resumed.state.opt_state),
                    tree_leaves(full.state.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(resumed.state.generator.get_state(),
                       full.state.generator.get_state())
    assert resumed.state.step == full.state.step
    assert rows(resumed.history) == rows(full.history)
    # A finished run resumes to its end without a step.
    again = run(small_setup, n_epochs=4, dropout=dropout, checkpoint_every=1,
                checkpoint_dir=str(tmp_path), resume=True)
    assert same(again, full) and rows(again.history) == rows(full.history)


def test_resume_without_checkpoint_starts_fresh(small_setup, tmp_path):
    res = run(small_setup, n_epochs=1, checkpoint_every=1,
              checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert same(res, run(small_setup, n_epochs=1))


def test_resume_falls_back_past_corrupt_latest_bit_identically(
        small_setup, tmp_path):
    kw = dict(dropout=0.2)
    full = run(small_setup, n_epochs=4, **kw)
    run(small_setup, n_epochs=2, checkpoint_every=1,
        checkpoint_dir=str(tmp_path), **kw)
    target = tmp_path / "ckpt_00002.npz"
    with open(target, "r+b") as f:
        f.seek(os.path.getsize(target) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.warns(UserWarning, match="falling back to the next newest"):
        resumed = run(small_setup, n_epochs=4, checkpoint_every=1,
                      checkpoint_dir=str(tmp_path), resume=True, **kw)
    assert same(resumed, full)
    assert rows(resumed.history) == rows(full.history)


def test_checkpoint_fault_truncates_latest_and_resume_falls_back(
        small_setup, tmp_path):
    """The injector's checkpoint site truncates the file LATEST points at
    after the pointer moved; resume falls back to the one before it."""
    full = run(small_setup, n_epochs=3, dropout=0.2)
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint", epoch=2,
                                              mode="truncate"),)))
    run(small_setup, n_epochs=2, dropout=0.2, checkpoint_every=1,
        checkpoint_dir=str(tmp_path), injector=inj)
    assert [f["path"] for f in inj.fired()] == ["ckpt_00002.npz"]
    with pytest.warns(UserWarning, match="ckpt_00002 is unusable"):
        resumed = run(small_setup, n_epochs=3, dropout=0.2,
                      checkpoint_every=1, checkpoint_dir=str(tmp_path),
                      resume=True)
    assert same(resumed, full)


def test_guard_counters_survive_resume(small_setup, tmp_path):
    full = run(small_setup, n_epochs=2, resilience=guard(),
               injector=FaultInjector(FaultPlan(POISON)))
    run(small_setup, n_epochs=1, resilience=guard(), checkpoint_every=1,
        checkpoint_dir=str(tmp_path),
        injector=FaultInjector(FaultPlan(POISON)))
    resumed = run(small_setup, n_epochs=2, resilience=guard(),
                  checkpoint_every=1, checkpoint_dir=str(tmp_path),
                  resume=True, injector=FaultInjector(FaultPlan(POISON)))
    assert [h["guard/skipped_total"] for h in resumed.history] == [1, 2]
    assert same(resumed, full)


# ------------------------------------------------------ supervised staging
def test_staging_crash_is_retried_under_the_supervisor(small_setup):
    """A prefetch event's step is a chunk: with one-step chunks, chunk 1
    is the put of step 1's batch."""
    inj = FaultInjector(FaultPlan((FaultEvent("prefetch", epoch=0, step=1,
                                              mode="crash"),)))
    res = run(small_setup, n_epochs=1, injector=inj, scan_chunk=1,
              resilience=ResilienceConfig(max_retries=2, backoff_base=0.0,
                                          backoff_max=0.0))
    assert [f["site"] for f in inj.fired()] == ["prefetch"]
    assert same(res, run(small_setup, n_epochs=1))


def test_hung_staging_is_abandoned_by_the_watchdog(small_setup):
    inj = FaultInjector(FaultPlan((FaultEvent("prefetch", epoch=0, step=0,
                                              mode="hang", arg=2.0),)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = run(small_setup, n_epochs=1, injector=inj,
                  resilience=ResilienceConfig(hang_timeout=0.2,
                                              backoff_base=0.0,
                                              backoff_max=0.0))
    assert same(res, run(small_setup, n_epochs=1))


def test_exhausted_staging_retries_reraise(small_setup):
    inj = FaultInjector(FaultPlan((FaultEvent("prefetch", epoch=0, step=0,
                                              mode="crash"),)))
    with pytest.raises(InjectedFault):
        run(small_setup, n_epochs=1, injector=inj,
            resilience=ResilienceConfig(max_retries=0))
