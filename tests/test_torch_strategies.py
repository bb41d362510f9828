"""The port's execution strategies against the reference's.

``async_ps`` (the §4 stale-gradient parameter server) and ``sync_mesh``
(the paper's k-worker synchronous SGD, here over ``torch.distributed``)
run on the port's copies of the corpus, graph and plan (bit-identical to
the reference's) from the reference's initial params.  Across packages,
params are held to atol 1e-6 and history values to rtol 1e-5 (float32
sums in other orders); within the port, results are held bit for bit: the
async engine against a verbatim round-robin loop in torch, a resumed async
run against an uninterrupted one, ``sync_mesh`` at world size 1 against
the sequential run.  ``sync_mesh`` at 2 and 4 ranks runs gloo ranks under
``torch.multiprocessing`` (``init_method=file://`` in the test's
directory, one thread a rank, a 120-s join deadline after which the ranks
are killed) and is held to the sequential run within the tolerances
above, at dropout 0 and 0.2: every rank draws the whole batch's masks.
The fault-site test holds both packages' engines to the chunk coordinates:
a ``prefetch`` or ``worker`` event at chunk c fires before step
``c·scan_chunk``.
"""
import dataclasses
import gc
import json
import os
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api.config as jconfig  # noqa: E402
import repro.resilience as jres  # noqa: E402
from repro.core.ssl_loss import SSLHyper as JHyper  # noqa: E402
from repro.data.pipeline import MetaBatchPipeline as JPipeline  # noqa: E402
from repro.models.dnn import DNNConfig as JDNN  # noqa: E402
from repro.models.dnn import init_dnn as jinit  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train.async_trainer import train_dnn_ssl_async as jasync  # noqa: E402
from repro.train.trainer import train_dnn_ssl as jtrain  # noqa: E402
import repro_torch.train.async_trainer as tasync_mod  # noqa: E402
from repro_torch.api import (STRATEGY, ExecutionConfig, Experiment,  # noqa: E402
                             ResilienceConfig)
from repro_torch.api.config import (BatchConfig, DataConfig,  # noqa: E402
                                    ExperimentConfig, TrainConfig)
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core import build_affinity_graph, plan_meta_batches  # noqa: E402
from repro_torch.core.ssl_loss import SSLHyper, tree_leaves  # noqa: E402
from repro_torch.data import drop_labels, make_corpus  # noqa: E402
from repro_torch.data.pipeline import MetaBatchPipeline  # noqa: E402
from repro_torch.models.dnn import DNNConfig  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.resilience import FaultEvent, FaultInjector, FaultPlan  # noqa: E402
from repro_torch.train import (AsyncPSStrategy, Engine,  # noqa: E402
                               SequentialStrategy, SyncMeshStrategy,
                               TrainState, train_dnn_ssl,
                               train_dnn_ssl_async)
from repro_torch.train.train_step import dnn_ssl_loss  # noqa: E402

MODEL = dict(input_dim=24, hidden_dim=32, n_hidden=2, n_classes=6,
             dropout=0.0)
CFG = DNNConfig(**MODEL)
HYPER = dict(gamma=0.3, kappa=1e-4, weight_decay=1e-5)
LR = 5e-3
PARAMS_ATOL = 1e-6
HIST_RTOL = 1e-5
JOIN_DEADLINE_S = 120.0


def _data():
    """Corpus (labels dropped), graph and plan: 10 meta-batches of 48."""
    corpus = make_corpus(480, n_classes=6, input_dim=24, manifold_dim=4,
                         seed=0)
    labeled = drop_labels(corpus, 0.2, seed=1)
    graph = build_affinity_graph(corpus.X, k=8)
    plan = plan_meta_batches(graph, batch_size=48, n_classes=6, seed=0)
    return labeled, graph, plan


@pytest.fixture(scope="module")
def setup():
    init = jax.device_get(jinit(JDNN(**MODEL), jax.random.PRNGKey(5)))
    return (*_data(), init)


def pipeline_of(setup, k=1, cls=MetaBatchPipeline):
    labeled, graph, plan, _ = setup
    return cls(labeled, graph, plan, n_workers=k, seed=0).epoch


def run(setup, *, k=1, n_epochs=2, dropout=0.0, **kw):
    """The port's run; ``async_ps`` takes 1-worker batches."""
    pipe_k = 1 if kw.get("strategy") == "async_ps" else k
    return train_dnn_ssl(pipeline_of(setup, pipe_k), cfg=CFG,
                         hyper=SSLHyper(**HYPER), n_epochs=n_epochs,
                         n_workers=k, dropout=dropout, base_lr=LR, seed=0,
                         params=setup[3], device="cpu", **kw)


def jrun(setup, *, k=1, n_epochs=2, **kw):
    pipe_k = 1 if kw.get("strategy") == "async_ps" else k
    return jtrain(pipeline_of(setup, pipe_k, JPipeline), cfg=JDNN(**MODEL),
                  hyper=JHyper(**HYPER), n_epochs=n_epochs, n_workers=k,
                  dropout=0.0, base_lr=LR, seed=0, pairwise="ref",
                  params=setup[3], **kw)


def leaves(params):
    return [np.asarray(x) for x in tree_leaves(to_numpy(params))]


def same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def rows(history):
    """History rows without the wall time."""
    return [{k: v for k, v in r.items() if k != "seconds"} for r in history]


def assert_close_to_reference(tparams, thist, jparams, jhist):
    for t, j in zip(leaves(tparams),
                    jax.tree.leaves(jax.device_get(jparams))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                   atol=PARAMS_ATOL)
    assert len(thist) == len(jhist)
    for trow, jrow in zip(thist, jhist):
        assert set(trow) == set(jrow)
        for key in jrow:
            if key != "seconds":
                np.testing.assert_allclose(trow[key], jrow[key],
                                           rtol=HIST_RTOL, err_msg=key)


# ------------------------------------------------------------- async_ps
@pytest.mark.parametrize("k,max_staleness", [(4, 2), (3, 1)])
def test_async_ps_matches_reference_train_dnn_ssl_async(setup, monkeypatch,
                                                        k, max_staleness):
    """``train_dnn_ssl_async`` in both packages from the reference's init
    of the same seed (the port's own init cannot draw threefry keys)."""
    monkeypatch.setattr(
        tasync_mod, "init_dnn", lambda cfg, seed, device=None: to_torch(
            jax.device_get(jinit(JDNN(**MODEL), jax.random.PRNGKey(seed))),
            device))
    kw = dict(hyper=None, n_epochs=2, n_workers=k,
              max_staleness=max_staleness, base_lr=LR, seed=0)
    jp, jh = jasync(pipeline_of(setup, 1, JPipeline), cfg=JDNN(**MODEL),
                    **{**kw, "hyper": JHyper(**HYPER)})
    tp, th = train_dnn_ssl_async(pipeline_of(setup), cfg=CFG,
                                 **{**kw, "hyper": SSLHyper(**HYPER)},
                                 device="cpu")
    assert [h["epoch"] for h in th] == [0, 1]
    assert [h["lr"] for h in th] == [float(np.float32(LR))] * 2
    assert_close_to_reference(tp, th, jp, jh)


def async_loop(pipeline_epoch, params, *, n_epochs, n_workers,
               max_staleness, lr):
    """A verbatim round-robin async loop in torch: worker ``step % k``
    takes the gradient at its snapshot, the server applies it at once, the
    worker pulls fresh params every ``max_staleness`` pushes."""
    hyper = SSLHyper(**HYPER)
    opt = adagrad()
    params = to_torch(params)
    opt_state = opt.init(params)

    def copy(p):
        return {"layers": [{"w": l["w"].clone(), "b": l["b"].clone()}
                           for l in p["layers"]]}

    snapshots = [copy(params) for _ in range(n_workers)]
    ages = [0] * n_workers
    for _ in range(n_epochs):
        for step, batch in enumerate(pipeline_epoch()):
            w = step % n_workers
            tb = {key: torch.from_numpy(np.ascontiguousarray(v))
                  for key, v in dataclasses.asdict(batch).items()
                  if v is not None}
            q = {"layers": [{"w": l["w"].detach().requires_grad_(True),
                             "b": l["b"].detach().requires_grad_(True)}
                            for l in snapshots[w]["layers"]]}
            loss, _ = dnn_ssl_loss(q, tb, CFG, hyper)
            grads = torch.autograd.grad(loss, tree_leaves(q))
            opt.update(list(grads), opt_state, params,
                       float(np.float32(lr)))
            ages[w] += 1
            if ages[w] >= max_staleness:
                snapshots[w] = copy(params)
                ages[w] = 0
    return params


@pytest.mark.parametrize("k,max_staleness", [(4, 2), (3, 1)])
def test_async_engine_equals_verbatim_loop_bit_for_bit(setup, k,
                                                       max_staleness):
    want = async_loop(pipeline_of(setup), setup[3], n_epochs=2,
                      n_workers=k, max_staleness=max_staleness, lr=LR)
    got = train_dnn_ssl(
        pipeline_of(setup), cfg=CFG, hyper=SSLHyper(**HYPER), n_epochs=2,
        n_workers=k, dropout=0.0, base_lr=LR, seed=0, params=setup[3],
        device="cpu", strategy="async_ps", max_staleness=max_staleness,
        pairwise=None)
    assert same(got.params, want)
    assert got.state.step == 2 * len(list(pipeline_of(setup)()))


def _archive(path) -> dict:
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def test_async_checkpoint_carries_snapshots_and_resumes_bit_for_bit(
        setup, tmp_path):
    """The checkpoint holds the whole carry (params, AdaGrad state, the k
    snapshots, the ages and t), so a resumed run ends with the
    uninterrupted run's checkpoint, array for array."""
    kw = dict(k=3, strategy="async_ps", max_staleness=2)
    full = run(setup, n_epochs=4, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "full"), **kw)
    run(setup, n_epochs=2, checkpoint_every=1,
        checkpoint_dir=str(tmp_path / "cut"), **kw)
    resumed = run(setup, n_epochs=4, checkpoint_every=1,
                  checkpoint_dir=str(tmp_path / "cut"), resume=True, **kw)
    want = _archive(tmp_path / "full" / "ckpt_00004.npz")
    got = _archive(tmp_path / "cut" / "ckpt_00004.npz")
    assert sorted(got) == sorted(want)
    assert sum(key.startswith("snapshots::") and "__dtype__" not in key
               for key in want) == 3 * 2 * (CFG.n_hidden + 1)
    assert int(want["t"]) == len(list(pipeline_of(setup)()))
    assert want["ages"].dtype == np.int32 and want["ages"].shape == (3,)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert same(resumed.params, full.params)
    assert rows(resumed.history) == rows(full.history)


def test_async_ps_refuses_dropout():
    with pytest.raises(ValueError, match="dropout"):
        train_dnn_ssl(lambda: iter(()), cfg=CFG, hyper=SSLHyper(**HYPER),
                      n_epochs=1, dropout=0.2, strategy="async_ps",
                      device="cpu")


def test_drop_overstale_worker_event_matches_reference(setup):
    """A dead worker at chunk 1 (``scan_chunk=2``: before step 2) under
    ``drop_overstale``: the port's params and history match the
    reference's run of the same plan, and a repeat is bit-identical."""
    events = (FaultEvent("worker", epoch=0, step=1, mode="dead", worker=1),)
    kw = dict(k=3, strategy="async_ps", scan_chunk=2, max_staleness=2,
              lr_schedule=lambda e: LR)
    res = run(setup, injector=FaultInjector(FaultPlan(events)),
              resilience=ResilienceConfig(drop_overstale=True), **kw)
    assert sum(h["async/dropped"] for h in res.history) > 0
    again = run(setup, injector=FaultInjector(FaultPlan(events)),
                resilience=ResilienceConfig(drop_overstale=True), **kw)
    assert same(res.params, again.params)
    assert rows(res.history) == rows(again.history)
    jevents = tuple(jres.FaultEvent(e.site, epoch=e.epoch, step=e.step,
                                    mode=e.mode, worker=e.worker)
                    for e in events)
    jinj = jres.FaultInjector(jres.FaultPlan(jevents))
    jout = jrun(setup, **kw, injector=jinj, resilience=jconfig.
                ResilienceConfig(drop_overstale=True))
    assert [f["site"] for f in jinj.fired()] == ["worker"]
    assert_close_to_reference(res.params, res.history, jout.params,
                              jout.history)


# ------------------------------------------------------------ sync_mesh
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_sync_mesh_world_size_one_equals_sequential_bit_for_bit(setup,
                                                                dropout):
    seq = run(setup, k=2, dropout=dropout)
    mesh = run(setup, k=2, dropout=dropout, strategy="sync_mesh")
    assert same(mesh.params, seq.params)
    assert rows(mesh.history) == rows(seq.history)
    assert mesh.state.generator.get_state().equal(
        seq.state.generator.get_state())


def test_sync_mesh_matches_reference_one_device_sync_mesh(setup):
    mesh = run(setup, k=2, strategy="sync_mesh")
    jmesh = jrun(setup, k=2, strategy="sync_mesh")
    assert_close_to_reference(mesh.params, mesh.history, jmesh.params,
                              jmesh.history)


def _tap(params, batch):
    """A capture of the batch's own rows: gathered over the ranks, it must
    be the whole k-worker batch in worker order."""
    return batch["x"][..., :3]


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One gloo rank: train sync_mesh at k = 4 at dropout 0 and 0.2, write
    its params and history."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        data = (*_data(), dict(np.load(os.path.join(workdir, "init.npz"))))
        init = {"layers": [{"w": data[3][f"w{i}"], "b": data[3][f"b{i}"]}
                           for i in range(CFG.n_hidden + 1)]}
        for dropout in (0.0, 0.2):
            captures = []
            res = train_dnn_ssl(
                pipeline_of((*data[:3], None), 4), cfg=CFG,
                hyper=SSLHyper(**HYPER), n_epochs=2, n_workers=4,
                dropout=dropout, base_lr=LR, seed=0, params=init,
                device="cpu", strategy="sync_mesh", capture_fn=_tap,
                capture_epochs={1},
                on_epoch_end=lambda e, p, c: captures.append(c))
            out = os.path.join(workdir, f"rank{rank}_{dropout}")
            np.savez(out + ".npz", *leaves(res.params))
            np.save(out + "_capture.npy", captures[1])
            with open(out + ".json", "w") as f:
                json.dump(rows(res.history), f)
    finally:
        dist.destroy_process_group()
        # destroy_process_group does not join a gloo group's worker
        # threads: freeing the group does, and the engines hold it in
        # reference cycles.  Free it while the interpreter is alive: a
        # worker that frees a Python tensor after finalization has begun
        # aborts the process ("terminate called without an active
        # exception").
        gc.collect()


@pytest.fixture(scope="module")
def multi_rank(setup, tmp_path_factory):
    """Each world size's ranks, run once for both dropout settings."""
    import torch.multiprocessing as mp
    init = {f"{key}{i}": layer[key]
            for i, layer in enumerate(setup[3]["layers"])
            for key in ("w", "b")}
    out = {}
    for world in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"sync_mesh_r{world}"))
        np.savez(os.path.join(workdir, "init.npz"), **init)
        ctx = mp.start_processes(_rank_main, args=(world, workdir),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_DEADLINE_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} gloo ranks still running "
                                       f"after {JOIN_DEADLINE_S:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out[world] = workdir
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_sync_mesh_gloo_ranks_match_sequential(setup, multi_rank, world,
                                               dropout):
    """Every rank holds the same params, within tolerance of the
    sequential run's, the same history, and the capture tap's output of
    the whole batch (gathered in worker order)."""
    captures = []
    seq = run(setup, k=4, dropout=dropout, capture_fn=_tap,
              capture_epochs={1},
              on_epoch_end=lambda e, p, c: captures.append(c))
    want = leaves(seq.params)
    got = []
    for rank in range(world):
        stem = os.path.join(multi_rank[world], f"rank{rank}_{dropout}")
        np.testing.assert_array_equal(np.load(stem + "_capture.npy"),
                                      captures[1])
        with np.load(stem + ".npz") as z:
            got.append([z[f"arr_{i}"] for i in range(len(z.files))])
        with open(stem + ".json") as f:
            hist = json.load(f)
        assert len(hist) == len(seq.history) == 2
        for trow, srow in zip(hist, rows(seq.history)):
            assert set(trow) == set(srow)
            for key in srow:
                np.testing.assert_allclose(trow[key], srow[key],
                                           rtol=HIST_RTOL, err_msg=key)
    for rank_leaves in got[1:]:          # every rank holds the same bits
        assert all(np.array_equal(a, b) for a, b in zip(rank_leaves, got[0]))
    for a, b in zip(got[0], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAMS_ATOL)


# ------------------------------------------------------ registry, engine
def test_strategy_registry_names_and_refusals():
    assert STRATEGY.names() == ["async_ps", "sequential", "sync_mesh"]
    assert STRATEGY.get("sequential") is SequentialStrategy
    assert STRATEGY.get("sync_mesh") is SyncMeshStrategy
    assert STRATEGY.get("async_ps") is AsyncPSStrategy
    with pytest.raises(KeyError, match="warp_drive"):
        STRATEGY.get("warp_drive")
    cpu = torch.device("cpu")
    step = lambda s, b, lr: {}  # noqa: E731
    with pytest.raises(KeyError, match="warp_drive"):
        Engine(step, device=cpu, strategy="warp_drive")
    with pytest.raises(ValueError, match="step_fn"):
        Engine(None, device=cpu, strategy="sequential")
    with pytest.raises(ValueError, match="grad_fn"):
        Engine(step, device=cpu, strategy="async_ps")
    with pytest.raises(ValueError, match="grad_fn"):
        Engine(step, device=cpu, strategy="sync_mesh")
    with pytest.raises(ValueError, match="mesh"):
        Engine(step, device=cpu, strategy="sync_mesh", grad_fn=step,
               opt=adagrad())
    with pytest.raises(ValueError, match="scan_chunk"):
        Engine(step, device=cpu, scan_chunk=-1)


def test_experiment_builds_one_worker_pipelines_for_async_ps():
    cfg = ExperimentConfig(
        data=DataConfig(n=480, n_classes=6, input_dim=24, manifold_dim=4),
        batch=BatchConfig(batch_size=48),
        train=TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=1,
                          n_workers=4, dropout=0.0),
        execution=ExecutionConfig(strategy="async_ps"))
    exp = Experiment(cfg, device="cpu").build()
    batches = list(exp.pipeline())
    assert batches[0].x.shape[0] == 1 and len(batches) == exp.plan.n_meta
    seq = Experiment(dataclasses.replace(
        cfg, execution=ExecutionConfig()), device="cpu").build()
    assert next(iter(seq.pipeline())).x.shape[0] == 4
    res = exp.run()
    assert len(res.history) == 1 and np.isfinite(res.final["loss/total"])


# -------------------------------------------------------- fault coordinates
class _Recording:
    """Wraps a strategy of either package: records, at each put, the step
    the put's batch (or chunk) starts and the faults fired so far, and at
    each worker bump the step it lands before."""

    def __init__(self, inner, injector, steps_of):
        self.inner, self.injector, self.steps_of = inner, injector, steps_of
        self.puts, self.bumps, self.next_step = [], [], 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def place_batch(self, batch, *args):
        self.puts.append((self.next_step, len(self.injector.fired())))
        self.next_step += self.steps_of(batch)
        return self.inner.place_batch(batch, *args)

    def bump_age(self, carry, worker, amount):
        self.bumps.append(int(self.inner.state_of(carry).step))
        return carry


def _coordinate_plan(pkg, chunk):
    return pkg.FaultInjector(pkg.FaultPlan((
        pkg.FaultEvent("prefetch", epoch=0, step=chunk, mode="crash"),
        pkg.FaultEvent("worker", epoch=0, step=chunk, mode="dead"))))


@pytest.mark.parametrize("scan_chunk,chunk", [(2, 1), (3, 2), (1, 4),
                                              (0, 0)])
def test_prefetch_and_worker_events_fire_before_step_c_times_scan_chunk(
        scan_chunk, chunk):
    """Both engines, 9 one-row batches, no prefetch lookahead: a crash at
    chunk c's put (retried by the supervisor) fires in the put that stages
    step c·S (the puts before it fired nothing), and a worker bump at
    chunk c lands on the carry before step c·S."""
    import repro_torch.resilience as tres
    batches = [{"x": np.full((1, 2), i, np.float32)} for i in range(9)]
    retry = dict(max_retries=1, backoff_base=0.0, backoff_max=0.0)
    for pkg in (jres, tres):
        inj = _coordinate_plan(pkg, chunk)
        if pkg is jres:
            eng = jengine.Engine(
                lambda s, b, lr: (dataclasses.replace(s, step=s.step + 1),
                                  {"m": jax.numpy.zeros(())}),
                scan_chunk=scan_chunk, prefetch=0, injector=inj,
                resilience=jconfig.ResilienceConfig(**retry))
            eng.strategy = _Recording(eng.strategy, inj,
                                      lambda c: len(c["x"]))
            state = jengine.TrainState.create({"w": jax.numpy.ones(2)}, {},
                                              jax.random.PRNGKey(0))
        else:
            def step_fn(s, b, lr):
                s.step += 1
                return {"m": torch.zeros(())}
            eng = Engine(step_fn, device=torch.device("cpu"),
                         scan_chunk=scan_chunk, prefetch=0, injector=inj,
                         resilience=ResilienceConfig(**retry))
            eng.strategy = _Recording(eng.strategy, inj, lambda b: 1)
            state = TrainState(params={"w": torch.ones(2)}, opt_state={})
        eng.run(lambda: iter(batches), state=state, n_epochs=1,
                lr_schedule=lambda e: 0.0)
        assert {f["site"] for f in inj.fired()} == {"prefetch", "worker"}
        fired_at = next(s for s, n in eng.strategy.puts if n > 0)
        assert fired_at == chunk * scan_chunk, (pkg.__name__, fired_at)
        assert eng.strategy.bumps == [chunk * scan_chunk], pkg.__name__
