"""The port's copies of the host modules build what the reference builds.

Same config and seed through both packages: the synthetic corpus, the k-NN
affinity graph (CSR), the partition plan and the first epoch's ``SSLBatch``
arrays must be bit-identical.  Also: configs round-trip through
``to_dict``/``from_dict`` and one config document drives either package.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def _build(core, data, pipe, pipeline, seed=0, k=2):
    corpus = data.make_corpus(900, n_classes=8, input_dim=20, manifold_dim=5,
                              seed=seed)
    corpus = data.drop_labels(corpus, 0.1, seed=seed + 1)
    graph = core.build_affinity_graph(corpus.X, k=8)
    plan = core.plan_meta_batches(graph, batch_size=128, n_classes=8,
                                  seed=seed)
    factory = getattr(pipe, pipeline)
    epoch = factory(corpus, graph, plan, n_workers=k, seed=seed,
                    batch_size=128)
    return corpus, graph, plan, list(epoch())


@pytest.fixture(scope="module")
def built():
    return {name: (_build(jcore, jdata, jpipe, name),
                   _build(tcore, tdata, tpipe, name))
            for name in ("make_meta_batch_pipeline",
                         "make_random_batch_pipeline")}


def test_corpus_graph_and_plan_are_bit_identical(built):
    (jc, jg, jp, _), (tc, tg, tp, _) = built["make_meta_batch_pipeline"]
    for f in ("X", "y", "label_mask"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.n_classes == jc.n_classes
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tg.W, f), getattr(jg.W, f))
    assert (tg.k, tg.sigma) == (jg.k, jg.sigma)
    np.testing.assert_array_equal(tp.mini_block_labels, jp.mini_block_labels)
    np.testing.assert_array_equal(tp.meta_of_block, jp.meta_of_block)
    assert len(tp.meta_batches) == len(jp.meta_batches)
    for a, b in zip(tp.meta_batches, jp.meta_batches):
        np.testing.assert_array_equal(a, b)
    assert (tp.batch_edges != jp.batch_edges).nnz == 0


@pytest.mark.parametrize("pipeline", ["make_meta_batch_pipeline",
                                      "make_random_batch_pipeline"])
def test_first_epoch_batches_are_bit_identical(built, pipeline):
    (_, _, _, jb), (_, _, _, tb) = built[pipeline]
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if y is None:
                assert x is None
                continue
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_config_round_trip_and_shared_documents():
    cfg = tapi.ExperimentConfig(
        name="rt", data=tapi.DataConfig(n=512, n_classes=39, input_dim=351),
        objective=tapi.ObjectiveConfig(gamma=0.5, tile_bi=64),
        train=tapi.TrainConfig(hidden_dim=2000, n_hidden=4),
        batch=tapi.BatchConfig(batch_size=1024))
    doc = cfg.to_dict()
    assert tapi.ExperimentConfig.from_dict(doc) == cfg
    # The same document means the same thing to the reference.
    jcfg = japi.ExperimentConfig.from_dict(doc)
    assert jcfg.to_dict() == doc
    assert tapi.ExperimentConfig().to_dict() == japi.ExperimentConfig().to_dict()
    # hyper() and tiles() build the port's own objects.
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.kernels.tuning import TileSpec
    assert cfg.objective.hyper() == SSLHyper(gamma=0.5, kappa=1e-4,
                                             weight_decay=1e-5)
    assert cfg.objective.tiles() == TileSpec(bi=64)
    with pytest.raises(ValueError, match="unknown keys"):
        tapi.ExperimentConfig.from_dict({"train": {"bogus": 1}})


def test_device_graph_construction_raises_until_ported():
    """The device backend (the streaming top-k K8, its plain version on the
    CPU) builds the reference's device graph; without a GPU, asking it for
    ``device="cuda"`` raises rather than dropping to the CPU."""
    X = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    tg = tcore.build_affinity_graph(X, k=5, backend="device", device="cpu")
    jg = jcore.build_affinity_graph(X, k=5, backend="device")
    assert tg.sigma == pytest.approx(jg.sigma, rel=1e-6)
    np.testing.assert_array_equal(tg.W.indices, jg.W.indices)
    np.testing.assert_array_equal(tg.W.indptr, jg.W.indptr)
    np.testing.assert_allclose(tg.W.data, jg.W.data, rtol=1e-5, atol=1e-6)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tcore.build_affinity_graph(X, k=5, backend="device")


def test_supervisor_copy_is_the_reference_module():
    """``repro_torch/resilience/supervisor.py`` is the reference's module
    with ``repro.`` imports rewritten (it has none), and its backoff
    schedule is the reference's bit for bit."""
    from pathlib import Path

    import repro.resilience.supervisor as jsup
    import repro_torch.resilience.supervisor as tsup
    want = Path(jsup.__file__).read_text().replace("repro.", "repro_torch.")
    assert Path(tsup.__file__).read_text() == want
    for kw in ({}, {"seed": 7, "backoff_base": 0.1, "jitter": 0.25}):
        jp, tp = jsup.RetryPolicy(**kw), tsup.RetryPolicy(**kw)
        for key in ("replan@1", "prefetch"):
            assert [tp.delay(key, a) for a in range(6)] == \
                [jp.delay(key, a) for a in range(6)]


def test_faults_copy_is_the_reference_module():
    """``repro_torch/resilience/faults.py`` is the reference's module with
    ``repro.`` imports rewritten (it has none): numpy only, and the same
    fault plans from the same seeds."""
    from pathlib import Path

    import repro.resilience.faults as jfaults
    import repro_torch.resilience.faults as tfaults
    want = Path(jfaults.__file__).read_text().replace("repro.",
                                                      "repro_torch.")
    assert Path(tfaults.__file__).read_text() == want
    for seed in (0, 5):
        kw = dict(n_epochs=3, steps_per_epoch=7, per_site=2)
        assert tfaults.FaultPlan.from_seed(seed, **kw).to_json() == \
            jfaults.FaultPlan.from_seed(seed, **kw).to_json()


def test_stats_copy_is_the_reference_module_and_bit_identical(built):
    """``repro_torch/core/stats.py`` is the reference's module with
    ``repro.`` imports rewritten (it has none); the Eq.-5 connectivity and
    the batch label entropy, their distributions and ``random_batches``
    equal the reference's bit for bit on the same graph and batches."""
    from pathlib import Path

    import repro.core.stats as jstats
    import repro_torch.core.stats as tstats
    want = Path(jstats.__file__).read_text().replace("repro.",
                                                     "repro_torch.")
    assert Path(tstats.__file__).read_text() == want
    assert tcore.within_batch_connectivity is tstats.within_batch_connectivity
    (jc, jg, jp, _), (tc, tg, tp, _) = built["make_meta_batch_pipeline"]
    rand = [pkg.random_batches(len(tc.y), 128, rng=np.random.default_rng(3))
            for pkg in (jstats, tstats)]
    for a, b in zip(*rand):
        np.testing.assert_array_equal(a, b)
    for batches in (list(tp.meta_batches), rand[1]):
        np.testing.assert_array_equal(
            tstats.connectivity_distribution(tg, batches),
            jstats.connectivity_distribution(jg, batches))
        np.testing.assert_array_equal(
            tstats.entropy_distribution(tc.y, batches, tc.n_classes),
            jstats.entropy_distribution(jc.y, batches, jc.n_classes))
    b = tp.meta_batches[0]
    assert tstats.within_batch_connectivity(tg, b) == \
        jstats.within_batch_connectivity(jg, b)
    assert tstats.batch_label_entropy(tc.y, b, 8) == \
        jstats.batch_label_entropy(jc.y, b, 8)
