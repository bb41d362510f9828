"""The port's online graph refresh against the reference's ``repro.online``.

Both packages get the same numpy inputs: a corpus, graph and plan built by
their (bit-identical) host modules, and the same embedding matrices or
captures.  The refresh and the ingestion are host numpy in both (the
``"device"`` backend runs K8's plain version on the CPU here), so graphs
and plans must agree exactly: the same edges and partition labels, weights
within rtol 1e-6 (the port's K8 plain version sums distances in another
order than the reference's host search).  End to end, ``Experiment`` with
``online.refresh_every=1`` trains two epochs in both packages from the
reference's initial params with dropout 0; ``loss/total`` agrees to rtol
1e-5, the tolerance of the other training parity tests (float32 sums in
other orders, carried through AdaGrad's near-sign updates).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api.config as jconfig  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.online.refresh as jrefresh  # noqa: E402
from repro.data.pipeline import MetaBatchStream as JStream  # noqa: E402
import repro_torch.api.config as tconfig  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.online.refresh as trefresh  # noqa: E402
from repro_torch.data.pipeline import MetaBatchStream as TStream  # noqa: E402

N, D, C, K = 600, 24, 6, 8


def _setup(core, data, stream_cls, online, config, **cfg_kw):
    corpus = data.make_corpus(N, n_classes=C, input_dim=D, manifold_dim=4,
                              seed=0)
    graph = core.build_affinity_graph(corpus.X, k=K)
    plan = core.plan_meta_batches(graph, batch_size=25, n_classes=C, seed=0)
    stream = stream_cls(corpus, graph, plan, n_workers=2,
                        record_indices=True, seed=0)
    kw = dict(batch_size=25, n_classes=C, seed=0,
              embed_fn=lambda params, X: X @ params)
    if online is tonline:
        kw["device"] = "cpu"
    mgr = online.OnlineManager(stream, corpus, graph,
                               config.OnlineConfig(**cfg_kw), **kw)
    return corpus, graph, stream, mgr


def _pair(**cfg_kw):
    return (_setup(jcore, jdata, JStream, jonline, jconfig, **cfg_kw),
            _setup(tcore, tdata, TStream, tonline, tconfig, **cfg_kw))


def _assert_same_graph(tg, jg, rtol=1e-6):
    np.testing.assert_array_equal(tg.W.indptr, jg.W.indptr)
    np.testing.assert_array_equal(tg.W.indices, jg.W.indices)
    np.testing.assert_allclose(tg.W.data, jg.W.data, rtol=rtol)
    assert tg.k == jg.k
    assert tg.sigma == pytest.approx(jg.sigma, rel=rtol)


def _assert_same_plan(tstream, jstream):
    tp, jp = tstream.snapshot()[0], jstream.snapshot()[0]
    np.testing.assert_array_equal(tp.mini_block_labels, jp.mini_block_labels)
    assert len(tp.meta_batches) == len(jp.meta_batches)
    for a, b in zip(tp.meta_batches, jp.meta_batches):
        np.testing.assert_array_equal(a, b)


def test_scatter_epoch_embeddings_matches_reference():
    rng = np.random.default_rng(0)
    caps = rng.normal(size=(3, 2, 5, 4)).astype(np.float32)
    indices = [[rng.choice(9, size=int(rng.integers(1, 6)), replace=False)
                for _ in range(2)] for _ in range(3)]
    got = trefresh.scatter_epoch_embeddings(caps, indices, 9)
    want = jrefresh.scatter_epoch_embeddings(caps, indices, 9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="index groups"):
        trefresh.scatter_epoch_embeddings(caps, indices[:1], 9)


def test_changed_endpoints_matches_reference():
    X = np.random.default_rng(1).normal(size=(80, 6)).astype(np.float32)
    ga = tcore.build_affinity_graph(X, k=5)
    gb = tcore.build_affinity_graph(X + 0.3 * np.random.default_rng(2)
                                    .normal(size=X.shape).astype(np.float32),
                                    k=5)
    got = trefresh._changed_endpoints(ga.W, gb.W)
    np.testing.assert_array_equal(
        got, jrefresh._changed_endpoints(ga.W, gb.W))
    assert got.size > 0
    assert trefresh._changed_endpoints(ga.W, ga.W).size == 0


@pytest.mark.parametrize("churn_threshold,path", [(1.0, "delta_refines"),
                                                  (0.0, "full_rebuilds")])
@pytest.mark.parametrize("bandwidth", ["global", "per_node"])
def test_manager_refresh_matches_reference(churn_threshold, path, bandwidth):
    """The same embeddings give the reference's graph, churn and plan, on
    the delta-repair path and on the re-plan path."""
    (jc, jg, js, jm), (tc, tg, ts, tm) = _pair(
        refresh_every=2, churn_threshold=churn_threshold,
        bandwidth=bandwidth)
    proj = np.random.default_rng(7).normal(size=(D, 16)).astype(np.float32)
    E = jc.X @ proj
    assert jm.refresh(1, E) and tm.refresh(1, E)
    _assert_same_graph(tm.graph, jm.graph)
    assert ts.snapshot()[1] is tm.graph
    assert tm.last_churn == jm.last_churn
    assert tm.stats == jm.stats and tm.stats[path] == 1
    _assert_same_plan(ts, js)


def test_manager_refresh_on_the_device_backend_matches_reference():
    """``OnlineConfig(backend="device")``: the port's refresh runs K8 (its
    plain version on a CPU tensor) and gives the reference host graph's
    edges; the weights agree within rtol 1e-5 (K8's plain version and the
    host search round the squared distances differently)."""
    (jc, jg, js, jm), (tc, tg, ts, tm) = _pair(refresh_every=2)
    (_, _, ts2, tm2), = [_setup(tcore, tdata, TStream, tonline, tconfig,
                                refresh_every=2, backend="device")]
    proj = np.random.default_rng(7).normal(size=(D, 16)).astype(np.float32)
    E = jc.X @ proj
    assert jm.refresh(1, E) and tm2.refresh(1, E)
    _assert_same_graph(tm2.graph, jm.graph, rtol=1e-5)
    _assert_same_plan(ts2, js)


def test_manager_on_epoch_end_matches_reference():
    """One recorded stream epoch in each package and captures made from
    its recorded indices: the hook refreshes to the reference's graph and
    plan."""
    (jc, jg, js, jm), (tc, tg, ts, tm) = _pair(refresh_every=1)
    proj = np.random.default_rng(3).normal(size=(D, 12)).astype(np.float32)
    E = jc.X @ proj + 1.0
    jb = list(js.epoch(epoch=0, n_epochs=2))
    tb = list(ts.epoch(epoch=0, n_epochs=2))
    assert len(jb) == len(tb) > 0
    idx = js.snapshot()[4]
    for a, b in zip(idx, ts.snapshot()[4]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    P = jb[0].x.shape[1]
    caps = np.zeros((len(idx), 2, P, 12), np.float32)
    for s, group in enumerate(idx):
        for w, rows in enumerate(group):
            caps[s, w, :len(rows)] = E[rows]
    jm.on_epoch_end(0, proj, caps)
    tm.on_epoch_end(0, proj, caps)
    _assert_same_graph(tm.graph, jm.graph)
    _assert_same_plan(ts, js)
    assert tm.stats == jm.stats and tm.stats["refreshes"] == 1


def test_manager_insert_and_evict_match_reference():
    (jc, jg, js, jm), (tc, tg, ts, tm) = _pair(refresh_every=2)
    X_new = np.random.default_rng(8).normal(size=(32, D)).astype(np.float32)
    jidx, tidx = jm.insert(X_new), tm.insert(X_new)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tidx, np.arange(N, N + 32))
    _assert_same_graph(tm.graph, jm.graph)
    _assert_same_plan(ts, js)
    assert ts.snapshot()[2].n == N + 32
    assert jm.evict(jidx) and tm.evict(tidx)
    _assert_same_graph(tm.graph, jm.graph)
    _assert_same_plan(ts, js)
    assert trefresh.edge_set(tm.graph) == trefresh.edge_set(tg)
    assert tm.stats == jm.stats
    assert tm.stats["full_rebuilds"] == 0 and tm.stats["inserts"] == 1


def test_insert_after_refresh_embeds_with_the_model():
    """After a refresh the graph lives in embedding space: new rows go
    through ``embed_fn`` at the freshest params, as in the reference."""
    (jc, jg, js, jm), (tc, tg, ts, tm) = _pair(refresh_every=1)
    proj = np.random.default_rng(4).normal(size=(D, 16)).astype(np.float32)
    for m in (jm, tm):
        m.params = proj
        assert m.refresh(0, jc.X @ proj)
    X_new = np.random.default_rng(5).normal(size=(8, D)).astype(np.float32)
    np.testing.assert_array_equal(tm.insert(X_new), jm.insert(X_new))
    _assert_same_graph(tm.graph, jm.graph)
    _assert_same_plan(ts, js)


def test_manager_requires_recorded_indices():
    (_, _, _, _), (tc, tg, ts, tm) = _pair(refresh_every=1)
    ts.record_indices = False
    ts.last_epoch_indices = None
    with pytest.raises(RuntimeError, match="record_indices"):
        tm.on_epoch_end(0, None, np.zeros((1, 2, 3, 4), np.float32))


def _online_config(config):
    return config.ExperimentConfig(
        data=config.DataConfig(n=400, n_classes=5, input_dim=16,
                               manifold_dim=4, label_ratio=0.2,
                               test_fraction=0.1),
        graph=config.GraphConfig(k=6),
        batch=config.BatchConfig(pipeline="metabatch_stream", batch_size=20),
        train=config.TrainConfig(n_epochs=2, n_workers=2, hidden_dim=32,
                                 n_hidden=2, dropout=0.0),
        execution=config.ExecutionConfig(scan_chunk=4, prefetch=0),
        online=config.OnlineConfig(refresh_every=1))


def test_experiment_online_refresh_matches_reference(monkeypatch):
    """Two epochs of ``Experiment`` with ``online.refresh_every=1`` in both
    packages from the reference's initial params: both refresh after each
    epoch from the captured top hidden layer, serve the same graph, and
    their ``loss/total`` agree."""
    import repro.train.trainer as jtrainer
    import repro_torch.train.trainer as ttrainer
    from repro.api import Experiment as JExperiment
    from repro.models.dnn import init_dnn as jinit
    from repro_torch.api import Experiment as TExperiment
    from repro_torch.convert import to_torch

    inits = []

    def capture(*a, **k):
        inits.append(jax.device_get(jinit(*a, **k)))
        return inits[-1]

    monkeypatch.setattr(jtrainer, "init_dnn", capture)
    jexp = JExperiment(_online_config(jconfig))
    jres = jexp.run()
    monkeypatch.setattr(ttrainer, "init_dnn",
                        lambda *a, device=None, **k: to_torch(inits[0],
                                                              device))
    texp = TExperiment(_online_config(tconfig), device="cpu")
    tres = texp.run()
    assert texp.online.stats == jexp.online.stats
    assert texp.online.stats["refreshes"] == 2
    _assert_same_graph(texp.pipeline.stream.snapshot()[1],
                       jexp.pipeline.stream.snapshot()[1], rtol=1e-4)
    assert len(tres.history) == len(jres.history) == 2
    for trow, jrow in zip(tres.history, jres.history):
        assert set(trow) == set(jrow)
        np.testing.assert_allclose(trow["loss/total"], jrow["loss/total"],
                                   rtol=1e-5)
