"""The port's chaos driver against the reference's.

``run_chaos(seed=7)`` on the CPU: the three phases (uninterrupted,
interrupted after the corrupted checkpoint, resumed past it) must give an
``ok`` report, with the reference's plan (its ``chaos_plan`` on the same
plan grid) and the reference's fired coordinates in phase A.  The fired
lists are compared as sets of events: the reference fires some sites on
its prefetch thread, so its ledger's order is not fixed.

Phase A is held to the reference's phase A run from the same initial
params (the reference's init, captured): history values to rtol 1e-5, and
params to atol 1e-6 but for at most 1 in 10,000 elements, which must stay
within 1e-4.  The chaos model is 3 × 512 wide, and some of its weight
gradients are of the size of AdaGrad's eps: there the float32 rounding of
the two packages' matmuls moves the normalised update lr·g/(√G + eps) of
a few elements of each 512 × 512 layer past 1e-6, also in a run with no
fault at all.  A fault taken one chunk late moves every element, far past
1e-4.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.resilience as jres  # noqa: E402
import repro.resilience.chaos as jchaos  # noqa: E402
import repro.train.trainer as jtrainer  # noqa: E402
from repro.api import Experiment as JExperiment  # noqa: E402
from repro.models.dnn import init_dnn as jinit  # noqa: E402
import repro_torch.train.trainer as ttrainer  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core.ssl_loss import tree_leaves  # noqa: E402
from repro_torch.api import Experiment as TExperiment  # noqa: E402
from repro_torch.resilience import chaos as tchaos  # noqa: E402

SEED = 7
PARAMS_ATOL = 1e-6
HIST_RTOL = 1e-5
#: Elements AdaGrad's eps regime may take past PARAMS_ATOL, and how far
#: (module docstring).
NEAR_EPS_SHARE = 1e-4
NEAR_EPS_ATOL = 1e-4


def _events(fired):
    return sorted(json.dumps(f, sort_keys=True) for f in fired)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's phase A and the port's three phases."""
    tmp = tmp_path_factory.mktemp("chaos")
    inits = []

    def capture(*a, **k):
        inits.append(jax.device_get(jinit(*a, **k)))
        return inits[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_dnn", capture)
        cfg = jchaos.chaos_config(str(tmp / "reference"), seed=SEED)
        base = JExperiment(cfg).build()
        steps = base.plan.n_meta
        plan = jchaos.chaos_plan(
            SEED, steps_per_epoch=steps,
            chunks_per_epoch=-(-steps // cfg.execution.scan_chunk))
        shared = {"corpus": base.corpus, "eval_data": base.eval_data,
                  "graph": base.graph, "plan": base.plan,
                  "hierarchy_cache": base.hierarchy_cache}
        jres_a, jinj = jchaos._run_phase(cfg, plan, shared=shared)
        mp.setattr(ttrainer, "init_dnn",
                   lambda *a, device=None, **k: to_torch(inits[0], device))
        report = tchaos.run_chaos(SEED, workdir=str(tmp / "port"),
                                  device="cpu")
        tcfg = tchaos.chaos_config(str(tmp / "port_a"), seed=SEED)
        tbase = TExperiment(tcfg, device="cpu").build()
        tres_a, _ = tchaos._run_phase(
            tcfg, tchaos.chaos_plan(SEED, steps_per_epoch=steps,
                                    chunks_per_epoch=-(-steps // 2)),
            shared={"corpus": tbase.corpus, "eval_data": tbase.eval_data,
                    "graph": tbase.graph, "plan": tbase.plan,
                    "hierarchy_cache": tbase.hierarchy_cache},
            device="cpu")
    return {"report": report, "port": tres_a, "plan": plan,
            "fired": jinj.fired(), "reference": jres_a}


def test_chaos_report_is_ok(runs):
    report = runs["report"]
    assert report["ok"] and report["device"] == "cpu"
    assert report["all_sites_fired"] and report["skip_counts_match"]
    assert report["resume_bit_identical"]
    assert report["planned_poisoned_batches"] == 2
    assert [report["phases"][p]["epochs"] for p in
            ("uninterrupted", "interrupted", "resume")] == [4, 2, 4]
    assert {f["site"] for f in report["phases"]["uninterrupted"]["fired"]} \
        == {"batch", "prefetch", "replan", "checkpoint", "worker"}


def test_chaos_plan_and_fired_coordinates_are_the_reference_s(runs):
    report = runs["report"]
    assert report["plan"] == runs["plan"].to_json()
    assert _events(report["phases"]["uninterrupted"]["fired"]) == \
        _events(runs["fired"])


def test_chaos_phase_a_matches_the_reference(runs):
    got = runs["port"]
    want = runs["reference"]
    for t, j in zip(tree_leaves(to_numpy(got.params)),
                    jax.tree.leaves(jax.device_get(want.params))):
        delta = np.abs(t - np.asarray(j))
        assert (delta > PARAMS_ATOL).mean() <= NEAR_EPS_SHARE, t.shape
        assert delta.max() <= NEAR_EPS_ATOL, t.shape
    assert len(got.history) == len(want.history) == 4
    for trow, jrow in zip(got.history, want.history):
        assert set(trow) == set(jrow)
        for key in jrow:
            if key != "seconds":
                np.testing.assert_allclose(trow[key], jrow[key],
                                           rtol=HIST_RTOL, err_msg=key)


@pytest.mark.parametrize("seed", [0, 3, 11, 19])
def test_chaos_plan_equals_reference_and_has_unique_keys(seed):
    kw = dict(steps_per_epoch=7, chunks_per_epoch=4)
    plan = tchaos.chaos_plan(seed, **kw)
    assert plan.to_json() == jchaos.chaos_plan(seed, **kw).to_json()
    keys = [e.key() for e in plan.events]
    assert len(keys) == len(set(keys))
    assert jres.FaultInjector(jres.FaultPlan(tuple(
        jres.FaultEvent(**dataclasses.asdict(e)) for e in plan.events)))


def test_chaos_cli_writes_an_ok_report(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert tchaos.main(["--seed", str(SEED), "--device", "cpu",
                        "--report", str(path),
                        "--workdir", str(tmp_path / "work")]) == 0
    report = json.loads(path.read_text())
    assert report["ok"] and report["seed"] == SEED
    assert "resume_bit_identical=True" in capsys.readouterr().out
