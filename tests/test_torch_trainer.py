"""The port's training loop against the reference's, and its entry points.

``train_dnn_ssl`` runs 2 epochs in both packages from the reference's init
params carried across, on identical pipelines (the port's host modules are
bit-identical copies), with dropout 0.  The reference runs its plain
``pairwise="ref"``; the port runs its default ``"auto"``, which on CPU
tensors is the plain version too.  Per-epoch means agree to ~3e-6 relative
(float32 sums in other orders, carried through ~lr·sign(g) AdaGrad updates
of near-zero gradients); they are held to rtol 1e-5.
"""
import json

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


@pytest.mark.parametrize("over,match", [
    (dict(execution=ExecutionConfig(strategy="sync_mesh")), "strategies"),
    (dict(execution=ExecutionConfig(strategy="async_ps")), "strategies"),
    (dict(execution=ExecutionConfig(checkpoint_every=1,
                                    checkpoint_dir="ckpt")), "checkpoint"),
    (dict(resilience=ResilienceConfig(nonfinite_guard=True)), "guard"),
    (dict(batch=BatchConfig(batch_size=96, layout_bt=32)), "block-sparse"),
    (dict(batch=BatchConfig(batch_size=96, pipeline="metabatch_stream"),
          online=OnlineConfig(refresh_every=1)), "online"),
])
def test_later_slice_features_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        Experiment(_tiny(**over), device="cpu").run()


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
