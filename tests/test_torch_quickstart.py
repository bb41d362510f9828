"""The port's quickstart (``repro_torch.examples.quickstart``) against the
reference's ``examples/quickstart.py``, on the CPU.

The config documents of both packages are held equal for the same flags.
Then the reference's ``main`` runs at n 600 and 2 epochs, its initial
params captured from ``init_dnn`` (as ``tests/test_torch_trainer.py``
captures them), and the twin's ``main`` runs with ``--device cpu`` from
those params: per epoch, the SSL run and the supervised run (γ = κ = 0)
of both packages agree, loss terms within rtol 1e-5 and ``eval/acc``
within 0.01, but for the SSL run's epochs after the first, whose loss
terms are held to rtol 5e-3.

Why.  AdaGrad's first update moves each weight by lr·g/(|g| + 1e-8),
±lr wherever |g| ≫ 1e-8, so a weight whose float32 gradient differs in
sign between the packages moves by ±lr = ±0.01 in each.  At the
parity run's initial params the two packages' float64 gradients agree
to ~1e-15, the port's float32 gradient lies within ~7e-7 of its largest
entry from them, and the reference's up to ~3e-3 on the hidden layers,
with the sign of 32 of 598,016 weights' gradients flipped
(``test_gradient_at_init_equals_the_references_in_float64``, printed
with ``-s``).  After that one step the next epoch's loss terms differ by
up to 5.1e-4 relative (2.2e-4 on loss/total, printed with ``-s``).  The
supervised run (γ = κ = 0) keeps rtol 1e-5.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.train.trainer as jtrainer  # noqa: E402
import repro_torch.train.trainer as ttrainer  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: The parity runs' flags: a small corpus, 2 epochs.
FLAGS = ["--n", "600", "--epochs", "2"]
LOSS_KEYS = ("loss/total", "loss/supervised", "loss/graph", "loss/l2")
#: Loss terms: rtol at the first epoch and, for the SSL run, after it.
RTOL, SSL_LATER_RTOL = 1e-5, 5e-3


def _reference_quickstart():
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mp, argv, *, train=True):
    """The reference's ``main`` with ``argv``: the configs it ran and, with
    ``train``, its results and initial params; without, its runs are
    stubbed (the corpus, graph and plan are still built)."""
    runs, inits = [], []
    run = japi.Experiment.run

    def recording(self):
        res = run(self) if train else japi.ExperimentResult(
            config=self.config, history=[], final={}, seconds=0.0)
        runs.append(res)
        return res

    init = jtrainer.init_dnn

    def capture(*a, **k):
        inits.append(jax.device_get(init(*a, **k)))
        return inits[-1]

    mp.setattr(japi.Experiment, "run", recording)
    mp.setattr(jtrainer, "init_dnn", capture)
    mp.setattr("sys.argv", ["quickstart.py", *argv])
    _reference_quickstart().main()
    return runs, inits


@pytest.fixture(scope="module")
def both():
    """The reference's and the twin's runs at :data:`FLAGS`, the twin's
    from the reference's initial params; each package's printed lines."""
    import contextlib
    import io
    with pytest.MonkeyPatch.context() as mp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jruns, inits = _run_reference(mp, FLAGS)
        ref_lines = out.getvalue().splitlines()
        queue = list(inits)
        mp.setattr(ttrainer, "init_dnn",
                   lambda *a, device=None, **k: to_torch(queue.pop(0),
                                                         device))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            truns = quickstart.main(FLAGS + ["--device", "cpu"])
        port_lines = out.getvalue().splitlines()
    assert len(inits) == 2 and not queue
    return {"ref": jruns, "port": truns, "ref_lines": ref_lines,
            "port_lines": port_lines, "init": inits[0]}


@pytest.mark.parametrize("argv", [
    [],
    ["--n", "600", "--epochs", "2", "--label-ratio", "0.05", "--gamma",
     "0.5", "--pairwise", "ref"],
    ["--pairwise", "fused"],
], ids=["defaults", "flags", "fused"])
def test_config_documents_equal_the_references(argv, monkeypatch):
    """``configs`` builds the reference's two documents (the SSL run and
    its supervised twin) from the same flags, defaults included."""
    runs, _ = _run_reference(monkeypatch, argv, train=False)
    args = dict(zip(argv[::2], argv[1::2]))
    ours = quickstart.configs(
        epochs=int(args.get("--epochs", 10)), n=int(args.get("--n", 4000)),
        label_ratio=float(args.get("--label-ratio", 0.02)),
        gamma=float(args.get("--gamma", 1.0)),
        pairwise=args.get("--pairwise", "auto"))
    assert [r.config.name for r in runs] == ["quickstart", "supervised"]
    for mine, theirs in zip(ours, runs):
        assert mine.to_dict() == theirs.config.to_dict()
    assert ours[1].objective.gamma == ours[1].objective.kappa == 0.0


@pytest.mark.parametrize("run", [0, 1], ids=["ssl", "supervised"])
def test_runs_agree_with_the_reference_per_epoch(both, run):
    """From the reference's initial params, on the same corpus, graph and
    plan (the supervised run on the SSL run's): loss terms within rtol
    1e-5 (the SSL run's after its first epoch within 5e-3: see the
    module's docstring) and eval/acc within 0.01 at every epoch."""
    tres, jres = both["port"][run], both["ref"][run]
    assert tres.config.to_dict() == jres.config.to_dict()
    assert len(tres.history) == len(jres.history) == 2
    for epoch, (trow, jrow) in enumerate(zip(tres.history, jres.history)):
        rtol = SSL_LATER_RTOL if run == 0 and epoch else RTOL
        print(f"quickstart run {run}, epoch {epoch}: |Δ| / |reference| "
              + ", ".join(f"{key} {abs(trow[key] - jrow[key]) / max(abs(jrow[key]), 1e-30):.2e}"
                          for key in LOSS_KEYS))
        for key in LOSS_KEYS:
            np.testing.assert_allclose(trow[key], jrow[key], rtol=rtol,
                                       err_msg=key)
        assert trow["epoch"] == jrow["epoch"] and trow["lr"] == jrow["lr"]
        assert abs(trow["eval/acc"] - jrow["eval/acc"]) <= 0.01
    if run == 1:
        assert all(row["loss/graph"] == 0.0 for row in tres.history)


def test_gradient_at_init_equals_the_references_in_float64(both):
    """The SSL run's first step: the port's gradient of the Eq.-3 loss at
    the reference's initial params of the parity run, on the first
    meta-batch of the quickstart's corpus (n 600), equals the
    reference's to 1e-12 of the largest entry in float64.  In float32
    the reference's lies up to ~1e-3 of the largest entry from it on the
    hidden layers, and the port's no farther: the conditioning that
    AdaGrad's sign-like first update turns into the SSL run's
    later-epoch drift, at the weights whose float32 gradients differ in
    sign (printed with ``-s``)."""
    from repro.api.registry import resolve_pairwise as jpairwise
    from repro.models.dnn import DNNConfig as JDNN
    from repro.train.train_step import dnn_ssl_grads as jgrads
    from repro_torch.api import Experiment
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.models.dnn import DNNConfig
    from repro_torch.train.train_step import dnn_ssl_grads

    cfg, _ = quickstart.configs(epochs=1, n=600)
    dims = dict(input_dim=128, hidden_dim=512, n_hidden=3, n_classes=16,
                dropout=0.0)
    init = both["init"]
    batch = next(iter(Experiment(cfg, device="cpu").build().pipeline()))
    arrays = {k: np.asarray(getattr(batch, k))
              for k in ("x", "y", "label_mask", "valid", "W")}
    hyper = cfg.objective.hyper()

    def port(dtype):
        params = {"layers": [{k: torch.from_numpy(np.array(v)).to(dtype)
                              for k, v in layer.items()}
                             for layer in init["layers"]]}
        b = {k: torch.from_numpy(v).to(dtype) if v.dtype.kind == "f"
             else torch.from_numpy(v) for k, v in arrays.items()}
        grads, _ = dnn_ssl_grads(params, b, cfg=DNNConfig(**dims),
                                 hyper=hyper,
                                 pairwise=resolve_pairwise("auto"))
        return [layer["w"].double().numpy() for layer in grads["layers"]]

    def reference(dtype):
        params = jax.tree.map(lambda a: jax.numpy.asarray(a, dtype), init)
        b = {k: jax.numpy.asarray(v, dtype) if v.dtype.kind == "f"
             else jax.numpy.asarray(v) for k, v in arrays.items()}
        grads, _ = jgrads(params, b, cfg=JDNN(**dims),
                          hyper=japi.ExperimentConfig.from_dict(
                              cfg.to_dict()).objective.hyper(),
                          pairwise=jpairwise("auto"))
        return [np.asarray(layer["w"], np.float64)
                for layer in grads["layers"]]

    with jax.enable_x64(True):
        ref64 = reference(np.float64)
    port64 = port(torch.float64)
    ref32, port32 = reference(np.float32), port(torch.float32)
    far, flips = [], 0
    for r64, p64, r32, p32 in zip(ref64, port64, ref32, port32):
        scale = np.abs(r64).max()
        assert np.abs(p64 - r64).max() <= 1e-12 * scale
        d_ref, d_port = (np.abs(g - r64).max() / scale for g in (r32, p32))
        far.append((d_ref, d_port))
        assert d_port <= min(2 * d_ref, 1e-5) + 1e-6
        # Where the signs differ, AdaGrad's first steps differ by 2·lr.
        flips += int((np.sign(r32) != np.sign(p32)).sum())
    print(f"float32 gradient at init, max |Δ vs float64| / max |g| by "
          f"layer (reference, port): {far}; weights whose float32 "
          f"gradients differ in sign: {flips} of "
          f"{sum(g.size for g in ref64)}")
    assert max(d for d, _ in far) > 1e-4   # the reference's, in float32


def test_main_prints_the_references_lines(both):
    """The corpus, graph and training lines are the reference's; each
    run's line adds its seconds and where it ran."""
    ref, port = both["ref_lines"], both["port_lines"]
    assert port[:3] == ref[:3]
    assert len(port) == len(ref) == 5
    for mine, theirs in zip(port[3:], ref[3:]):
        assert mine.startswith(theirs.split(":")[0] + ":")
        assert mine.endswith("s on cpu)")


def test_main_raises_without_a_gpu():
    """No ``--device``: the card, and a raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main(FLAGS)
