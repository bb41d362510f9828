"""The port's training loop against the reference's, and its entry points.

``train_dnn_ssl`` runs 2 epochs in both packages from the reference's init
params carried across, on identical pipelines (the port's host modules are
bit-identical copies), with dropout 0.  The reference runs its plain
``pairwise="ref"``; the port runs its default ``"auto"``, which on CPU
tensors is the plain version too.  Per-epoch means agree to ~3e-6 relative
(float32 sums in other orders, carried through ~lr·sign(g) AdaGrad updates
of near-zero gradients); they are held to rtol 1e-5.  The same holds for
two epochs of ``Experiment`` with block-sparse batches (``layout_bt``).
"""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
from repro.core.ssl_loss import SSLHyper as JHyper  # noqa: E402
from repro.data.pipeline import make_meta_batch_pipeline as jmake  # noqa: E402
from repro.models.dnn import DNNConfig as JDNN  # noqa: E402
from repro.models.dnn import init_dnn as jinit  # noqa: E402
from repro.train.trainer import train_dnn_ssl as jtrain  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.api import (BatchConfig, DataConfig, ExecutionConfig,  # noqa: E402
                             Experiment, ExperimentConfig, OnlineConfig,
                             ResilienceConfig, TrainConfig)
from repro_torch.core.ssl_loss import SSLHyper as THyper  # noqa: E402
from repro_torch.kernels.tuning import TileSpec  # noqa: E402
from repro_torch.data.pipeline import make_meta_batch_pipeline as tmake  # noqa: E402
from repro_torch.models.dnn import DNNConfig as TDNN  # noqa: E402
from repro_torch.train.trainer import train_dnn_ssl as ttrain  # noqa: E402

HYPER = dict(gamma=1.0, kappa=1e-4, weight_decay=1e-5)
MODEL = dict(input_dim=16, hidden_dim=32, n_hidden=2, n_classes=8,
             dropout=0.0)


def _pipeline(core, data, make):
    corpus = data.make_corpus(700, n_classes=8, input_dim=16, manifold_dim=4,
                              seed=0)
    corpus = data.drop_labels(corpus, 0.2, seed=1)
    graph = core.build_affinity_graph(corpus.X, k=8)
    plan = core.plan_meta_batches(graph, batch_size=96, n_classes=8, seed=0)
    test = (corpus.X[:200], corpus.y[:200])
    return make(corpus, graph, plan, n_workers=2, seed=0), test


def test_two_epochs_match_reference_history():
    params = jax.device_get(jinit(JDNN(**MODEL), jax.random.PRNGKey(3)))
    jpipe, test = _pipeline(jcore, jdata, jmake)
    jres = jtrain(jpipe, cfg=JDNN(**MODEL), hyper=JHyper(**HYPER),
                  n_epochs=2, n_workers=2, dropout=0.0, eval_data=test,
                  pairwise="ref", params=params, scan_chunk=4)
    tpipe, test = _pipeline(tcore, tdata, tmake)
    tres = ttrain(tpipe, cfg=TDNN(**MODEL), hyper=THyper(**HYPER),
                  n_epochs=2, n_workers=2, dropout=0.0, eval_data=test,
                  params=params, device="cpu")
    assert len(tres.history) == len(jres.history) == 2
    for trow, jrow in zip(tres.history, jres.history):
        assert set(trow) == set(jrow)
        for k in ("loss/total", "loss/supervised", "loss/graph", "loss/l2"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-5)
        assert trow["lr"] == jrow["lr"] and trow["epoch"] == jrow["epoch"]
        assert abs(trow["eval/acc"] - jrow["eval/acc"]) <= 0.01
    # Caller-given params are copied, never updated in place.
    assert np.array_equal(params["layers"][0]["w"],
                          jax.device_get(jinit(JDNN(**MODEL),
                                               jax.random.PRNGKey(3)))
                          ["layers"][0]["w"])


def _tiny(**over):
    base = dict(data=DataConfig(n=500, n_classes=8, input_dim=16,
                                manifold_dim=4),
                train=TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=2),
                batch=BatchConfig(batch_size=96))
    base.update(over)
    return ExperimentConfig(**base)


def test_experiment_runs_end_to_end_on_cpu():
    res = Experiment(_tiny(), device="cpu").run()
    assert [r["epoch"] for r in res.history] == [0, 1]
    row = res.final
    assert {"loss/total", "loss/supervised", "loss/graph", "loss/l2",
            "acc/labeled", "epoch", "lr", "seconds", "eval/acc"} == set(row)
    assert np.isfinite(row["loss/total"]) and 0.0 <= row["eval/acc"] <= 1.0
    assert res.params["layers"][0]["w"].device.type == "cpu"


def test_experiment_with_block_layout_matches_reference(monkeypatch):
    """``BatchConfig(layout_bt=32)``: two epochs of the port's
    ``Experiment`` on the CPU (block-sparse Function, plain K4–K6) against
    the reference's ``Experiment`` from the same config document and the
    same initial params (captured from the reference's init), dropout 0."""
    import repro.train.trainer as jtrainer
    import repro_torch.train.trainer as ttrainer
    from repro.api import Experiment as JExperiment
    from repro.api import ExperimentConfig as JConfig
    from repro_torch.convert import to_torch

    cfg = _tiny(batch=BatchConfig(batch_size=96, layout_bt=32),
                train=TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=2,
                                  dropout=0.0))
    inits = []

    def capture(*a, **k):
        inits.append(jax.device_get(jinit(*a, **k)))
        return inits[-1]

    monkeypatch.setattr(jtrainer, "init_dnn", capture)
    jres = JExperiment(JConfig.from_dict(cfg.to_dict())).run()
    monkeypatch.setattr(ttrainer, "init_dnn",
                        lambda *a, device=None, **k: to_torch(inits[0],
                                                              device))
    exp = Experiment(cfg, device="cpu")
    tres = exp.run()
    assert exp.tiles() == TileSpec(bi=32)
    assert len(tres.history) == len(jres.history) == 2
    for trow, jrow in zip(tres.history, jres.history):
        assert set(trow) == set(jrow)
        for k in ("loss/total", "loss/supervised", "loss/graph", "loss/l2"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-5)
        assert trow["lr"] == jrow["lr"] and trow["epoch"] == jrow["epoch"]
        assert abs(trow["eval/acc"] - jrow["eval/acc"]) <= 0.01
    batch = next(iter(exp.pipeline()))
    assert batch.tile_occ is not None and not batch.tile_occ.all()


@pytest.mark.parametrize("strategy", ["sync_mesh", "async_ps"])
def test_later_slice_features_raise(strategy):
    """The execution strategies, which the port refused before they were
    ported, now run through ``Experiment``: ``sync_mesh`` on a world-size-1
    gloo group equals the sequential run bit for bit (dropout on), and
    ``async_ps`` trains on 1-worker batches."""
    def rows(res):
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in res.history]

    train = TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=2, n_workers=2,
                        dropout=0.2 if strategy == "sync_mesh" else 0.0)
    exp = Experiment(_tiny(train=train,
                           execution=ExecutionConfig(strategy=strategy)),
                     device="cpu")
    res = exp.run()
    assert [r["epoch"] for r in res.history] == [0, 1]
    assert np.isfinite(res.final["loss/total"])
    if strategy == "async_ps":
        assert next(iter(exp.pipeline())).x.shape[0] == 1
        assert res.final["lr"] == np.float32(train.base_lr)
        return
    seq = Experiment(_tiny(train=train), device="cpu").run()
    assert rows(res) == rows(seq)
    for a, b in zip(tcore.ssl_loss.tree_leaves(res.params),
                    tcore.ssl_loss.tree_leaves(seq.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("feature", ["checkpoint", "guard", "online"])
def test_engine_extras_run_through_experiment(feature, tmp_path):
    """Checkpointing, the non-finite guard and the online refresh, which
    the port refused before the engine extras were ported, now run."""
    over = {
        "checkpoint": dict(execution=ExecutionConfig(
            checkpoint_every=1, checkpoint_dir=str(tmp_path))),
        "guard": dict(resilience=ResilienceConfig(nonfinite_guard=True)),
        "online": dict(batch=BatchConfig(batch_size=96,
                                         pipeline="metabatch_stream"),
                       online=OnlineConfig(refresh_every=1)),
    }[feature]
    exp = Experiment(_tiny(**over), device="cpu")
    res = exp.run()
    assert [r["epoch"] for r in res.history] == [0, 1]
    assert np.isfinite(res.final["loss/total"])
    if feature == "checkpoint":
        assert (tmp_path / "LATEST").read_text() == "ckpt_00002"
    elif feature == "guard":
        assert res.final["guard/skipped_total"] == 0
    else:
        assert exp.online.stats["refreshes"] == 2


def test_cli_dump_config_and_cpu_run(tmp_path, capsys):
    from repro_torch.api import run
    run.main(["--dump-config"])
    doc = capsys.readouterr().out
    assert ExperimentConfig.from_dict(json.loads(doc)) == \
        ExperimentConfig()
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(_tiny().to_dict()))
    run.main(["--config", str(path), "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch   0" in out and "on cpu" in out


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_engine_stages_prefetch_batches_ahead(prefetch):
    """When step i runs, exactly the batches up to i + prefetch have been
    taken from the pipeline (each step reads its own batch)."""
    from repro_torch.train.engine import Engine, TrainState
    n, pulled, seen = 5, [], []

    def epoch():
        for i in range(n):
            pulled.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    def step_fn(state, batch, lr):
        seen.append((int(batch["x"][0]), len(pulled)))
        return {"loss/total": torch.zeros(())}

    Engine(step_fn, device=torch.device("cpu"), prefetch=prefetch).run(
        epoch, state=TrainState(params={}, opt_state=None), n_epochs=1,
        lr_schedule=lambda e: 0.1)
    assert seen == [(i, min(n, i + 1 + prefetch)) for i in range(n)]
    with pytest.raises(ValueError, match="prefetch"):
        Engine(step_fn, device=torch.device("cpu"), prefetch=-1)


def _stream_config(**resilience):
    from repro_torch.api import RepartitionConfig
    return _tiny(batch=BatchConfig(batch_size=96, pipeline="metabatch_stream"),
                 repartition=RepartitionConfig(every_n_epochs=1),
                 resilience=ResilienceConfig(**resilience),
                 train=TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=2,
                                   dropout=0.0))


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if y is None:
                assert x is None
                continue
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_stream_replan_runs_under_the_reference_supervisor(monkeypatch):
    """``metabatch_stream`` with a replan every epoch and the default
    resilience: the port's stream holds the reference's replan supervisor,
    re-plans epoch 1 to the reference's bits, and two epochs of
    ``Experiment`` agree with the reference's (rtol 1e-5, from the same
    initial params, dropout 0)."""
    import repro.train.trainer as jtrainer
    import repro_torch.train.trainer as ttrainer
    from repro.api import Experiment as JExperiment
    from repro.api import ExperimentConfig as JConfig
    from repro.resilience.supervisor import Supervisor as JSupervisor
    from repro_torch.convert import to_torch
    from repro_torch.resilience import Supervisor

    cfg = _stream_config()
    assert cfg.resilience.max_retries == 3
    inits = []

    def capture(*a, **k):
        inits.append(jax.device_get(jinit(*a, **k)))
        return inits[-1]

    monkeypatch.setattr(jtrainer, "init_dnn", capture)
    jexp = JExperiment(JConfig.from_dict(cfg.to_dict()))
    jres = jexp.run()
    monkeypatch.setattr(ttrainer, "init_dnn",
                        lambda *a, device=None, **k: to_torch(inits[0],
                                                              device))
    texp = Experiment(cfg, device="cpu")
    tres = texp.run()
    tstream, jstream = texp.pipeline.stream, jexp.pipeline.stream
    assert isinstance(jstream.supervisor, JSupervisor)
    assert isinstance(tstream.supervisor, Supervisor)
    assert tstream.supervisor.name == "replan"
    assert tstream.supervisor.policy.max_retries == 3
    assert tstream.swaps == jstream.swaps == 1
    assert tstream.plan is not texp.plan
    _assert_same_batches(list(texp.pipeline(epoch=1, n_epochs=2)),
                         list(jexp.pipeline(epoch=1, n_epochs=2)))
    assert len(tres.history) == len(jres.history) == 2
    for trow, jrow in zip(tres.history, jres.history):
        for k in ("loss/total", "loss/supervised", "loss/graph", "loss/l2"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-5)


@pytest.mark.parametrize("max_retries", [3, 0])
def test_failed_replan_is_retried_as_in_the_reference(monkeypatch,
                                                      max_retries):
    """``_synthesize`` fails once in both packages: with retries on (the
    default) the supervisor retries it and epoch 1 runs the new plan, bit
    for bit the reference's; with ``max_retries=0`` both keep the old
    plan."""
    from repro.api import Experiment as JExperiment
    from repro.api import ExperimentConfig as JConfig
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe

    cfg = _stream_config(max_retries=max_retries)
    texp = Experiment(cfg, device="cpu").build()
    jexp = JExperiment(JConfig.from_dict(cfg.to_dict()),
                       corpus=texp.corpus, eval_data=texp.eval_data)
    calls = {}
    for name, mod in (("port", tpipe), ("reference", jpipe)):
        real = mod.MetaBatchStream._synthesize

        def flaky(self, epoch, real=real, name=name):
            calls[name] = calls.get(name, 0) + 1
            if calls[name] == 1:
                raise RuntimeError("injected replan failure")
            return real(self, epoch)

        monkeypatch.setattr(mod.MetaBatchStream, "_synthesize", flaky)
    jexp.build()
    epochs = {}
    for name, exp in (("port", texp), ("reference", jexp)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            list(exp.pipeline(epoch=0, n_epochs=2))
            epochs[name] = list(exp.pipeline(epoch=1, n_epochs=2))
    tstream, jstream = texp.pipeline.stream, jexp.pipeline.stream
    if max_retries:
        assert calls == {"port": 2, "reference": 2}
        assert tstream.swaps == jstream.swaps == 1
        assert [(e["key"], e["attempt"], e["status"])
                for e in tstream.supervisor.events()] == \
            [("replan@1", 0, "retrying"), ("replan@1", 1, "recovered")]
        assert tstream.supervisor.events() == jstream.supervisor.events()
    else:
        assert tstream.supervisor is None and jstream.supervisor is None
        assert calls == {"port": 1, "reference": 1}
        assert tstream.swaps == jstream.swaps == 0
        assert tstream.plan is texp.plan
    _assert_same_batches(epochs["port"], epochs["reference"])
