"""Eq.-3 objective, DNN, optimizers and one SSL train step: port vs reference.

Inputs are numpy arrays from a seed, fed to both packages.  Float32 sums
run in different orders in XLA and in PyTorch, so values agree to ~1e-6
relative; losses and metrics are held to rtol 1e-5, gradients to rtol 1e-4
with an atol of 1e-5 of the largest gradient magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ssl_loss as jloss  # noqa: E402
from repro.models import dnn as jdnn  # noqa: E402
from repro.optim import adagrad as jadagrad  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core import ssl_loss as tloss  # noqa: E402
from repro_torch.models import dnn as tdnn  # noqa: E402
from repro_torch.optim import adagrad, adam, sgd  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

LR = 1e-3


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _objective_inputs(B=120, C=39, seed=0):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(B, C))).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    mask = (rng.random(B) < 0.3).astype(np.float32)
    W = rng.random((B, B)) * (rng.random((B, B)) < 0.1)
    return logits, labels, mask, (W + W.T).astype(np.float32)


def _params_np(cfg, seed=0):
    return jax.device_get(jdnn.init_dnn(cfg, jax.random.PRNGKey(seed)))


HYPER = dict(gamma=0.9, kappa=1e-3, weight_decay=1e-4)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("pairwise", [None, "ref", "fused"])
def test_ssl_objective_matches_reference(reduction, pairwise):
    logits, labels, mask, W = _objective_inputs()
    cfg = jdnn.DNNConfig(input_dim=8, hidden_dim=16, n_hidden=1, n_classes=4)
    params = _params_np(cfg)
    jl, jm = jloss.ssl_objective(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(W), jloss.SSLHyper(**HYPER), params=params,
        pairwise=pairwise, reduction=reduction)
    tl, tm = tloss.ssl_objective(
        torch.tensor(logits), torch.tensor(labels), torch.tensor(mask),
        torch.tensor(W), tloss.SSLHyper(**HYPER),
        params=to_torch(params), pairwise=pairwise,
        reduction=reduction)
    _close(tl.item(), float(jl))
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k].item(), float(jm[k]))


def test_ssl_objective_worker_axis_is_per_worker():
    ins = [_objective_inputs(seed=s) for s in range(2)]
    stacked = [torch.tensor(np.stack(a)) for a in zip(*ins)]
    hyper = tloss.SSLHyper(**HYPER)
    loss, metrics = tloss.ssl_objective(*stacked, hyper, pairwise="fused")
    assert loss.shape == (2,)
    for z, one in enumerate(ins):
        l1, m1 = tloss.ssl_objective(*map(torch.tensor, one), hyper,
                                     pairwise="fused")
        _close(loss[z].item(), l1.item(), rtol=1e-6)
        for k in m1:
            per = metrics[k] if metrics[k].dim() == 0 else metrics[k][z]
            _close(per.item(), m1[k].item(), rtol=1e-6)


def test_kl_form_matches_reference():
    logits, labels, mask, W = _objective_inputs(seed=3)
    hyper = dict(gamma=0.5, kappa=0.1, weight_decay=0.0)
    want = jloss.ssl_objective_kl_form(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(W), jloss.SSLHyper(**hyper))
    got = tloss.ssl_objective_kl_form(
        torch.tensor(logits), torch.tensor(labels), torch.tensor(mask),
        torch.tensor(W), tloss.SSLHyper(**hyper))
    _close(got.item(), float(want))


def test_l2_penalty_covers_every_leaf_in_reference_order():
    cfg = jdnn.DNNConfig(input_dim=5, hidden_dim=7, n_hidden=2, n_classes=3)
    params = _params_np(cfg)
    params["layers"][0]["b"] = np.full(7, 0.5, np.float32)  # biases count
    want = float(jloss.l2_penalty(params))
    got = tloss.l2_penalty(to_torch(params)).item()
    _close(got, want, rtol=1e-6)
    assert [t.shape for t in tloss.tree_leaves(to_torch(params))] == \
        [a.shape for a in jax.tree_util.tree_leaves(params)]


def test_dnn_forward_after_convert_matches_reference():
    cfg = jdnn.DNNConfig(input_dim=24, hidden_dim=48, n_hidden=3,
                         n_classes=39)
    params = _params_np(cfg, seed=5)
    x = np.random.default_rng(1).normal(size=(2, 70, 24)).astype(np.float32)
    want = jdnn.dnn_forward(params, jnp.asarray(x))
    got = tdnn.dnn_forward(to_torch(params), torch.tensor(x))
    _close(got.numpy(), want)
    want_h = jdnn.dnn_hidden(params, jnp.asarray(x[0]), layer=1)
    got_h = tdnn.dnn_hidden(to_torch(params), torch.tensor(x[0]),
                            layer=1)
    _close(got_h.numpy(), want_h)
    back = to_numpy(to_torch(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_init_has_the_reference_distribution():
    """Threefry and torch draws differ; the distribution must not."""
    cfg = tdnn.DNNConfig(input_dim=351, hidden_dim=400, n_hidden=2,
                         n_classes=39)
    p = tdnn.init_dnn(cfg, 0)
    dims = [351, 400, 400, 39]
    for i, lyr in enumerate(p["layers"]):
        assert tuple(lyr["w"].shape) == (dims[i], dims[i + 1])
        std = float(lyr["w"].std())
        assert abs(std / (2.0 / dims[i]) ** 0.5 - 1) < 0.05
        assert float(lyr["b"].abs().max()) == 0.0
    again = tdnn.init_dnn(cfg, 0)
    assert torch.equal(p["layers"][0]["w"], again["layers"][0]["w"])


def test_dropout_keeps_its_rate():
    d, n, rate = 128, 2000, 0.2
    eye = torch.eye(d)
    params = {"layers": [{"w": eye, "b": torch.zeros(d)},
                         {"w": eye, "b": torch.zeros(d)}]}
    x = torch.rand(n, d) + 0.5                     # post-ReLU stays > 0
    out = tdnn.dnn_forward(params, x, dropout=rate,
                           generator=torch.Generator().manual_seed(0))
    dropped = (out == 0).float().mean().item()
    assert abs(dropped - rate) < 0.01
    kept = out != 0
    _close(out[kept].numpy(), (x[kept] / (1 - rate)).numpy(), rtol=1e-6)
    assert torch.equal(tdnn.dnn_forward(params, x), x)   # no generator: off


@pytest.mark.parametrize("name", ["adagrad", "sgd", "adam"])
def test_optimizers_match_reference(name):
    cfg = jdnn.DNNConfig(input_dim=6, hidden_dim=9, n_hidden=1, n_classes=4)
    params = _params_np(cfg)
    jopt, topt = {"adagrad": (jadagrad(), adagrad()),
                  "sgd": (jsgd(momentum=0.9), sgd(momentum=0.9)),
                  "adam": (jadam(), adam())}[name]
    jp, js = params, jopt.init(params)
    tp = to_torch(params)
    ts = topt.init(tp)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        jp, js = jopt.update(grads, js, jp, jnp.float32(0.01))
        tp, ts = topt.update(to_torch(grads), ts, tp, 0.01)
    for a, b in zip(tloss.tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(jax.device_get(jp))):
        _close(a, b, rtol=1e-5)
    if name == "adagrad":
        back = to_torch(jax.device_get(js))
        for a, b in zip(tloss.tree_leaves(back), tloss.tree_leaves(ts)):
            _close(a.numpy(), b.numpy(), rtol=1e-6)
        assert set(to_numpy(ts)) == {"accum"}


def _step_batch(k=2, P=96, D=16, C=39, n_valid=(80, 90), seed=4):
    rng = np.random.default_rng(seed)
    W = rng.random((k, P, P)) * (rng.random((k, P, P)) < 0.1)
    valid = np.zeros((k, P), bool)
    for z, n in enumerate(n_valid):
        valid[z, :n] = True
    return {"x": rng.normal(size=(k, P, D)).astype(np.float32),
            "y": rng.integers(0, C, (k, P)).astype(np.int32),
            "label_mask": (rng.random((k, P)) < 0.4).astype(np.float32),
            "W": (W + W.transpose(0, 2, 1)).astype(np.float32),
            "valid": valid}


@pytest.mark.parametrize("pairwise", ["ref", "fused"])
def test_one_ssl_step_matches_reference(pairwise):
    """k=2 workers, padded rows, dropout 0: loss, metrics, grads and the
    AdaGrad-updated params agree with the reference's step."""
    cfg = jdnn.DNNConfig(input_dim=16, hidden_dim=48, n_hidden=2,
                         n_classes=39, dropout=0.0)
    params = _params_np(cfg, seed=1)
    batch = _step_batch()
    jh = jloss.SSLHyper(**HYPER)
    th = tloss.SSLHyper(**HYPER)

    jgrads, jmet = jstep.dnn_ssl_grads(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=cfg,
        hyper=jh, pairwise=pairwise)
    jopt = jadagrad()
    jnew, _, _ = jstep.dnn_ssl_step(
        params, jopt.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        cfg=cfg, hyper=jh, opt=jopt, lr=jnp.float32(LR), pairwise=pairwise)

    tcfg = tdnn.DNNConfig(**vars(cfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = to_torch(params)
    tgrads, tmet = tstep.dnn_ssl_grads(tp, tbatch, cfg=tcfg, hyper=th,
                                       pairwise=pairwise)
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close(tmet[k].item(), float(jmet[k]))
    for a, b in zip(tloss.tree_leaves(to_numpy(tgrads)),
                    jax.tree_util.tree_leaves(jax.device_get(jgrads))):
        _close(a, b, rtol=1e-4)

    topt = adagrad()
    tnew, _, _ = tstep.dnn_ssl_step(tp, topt.init(tp), tbatch, cfg=tcfg,
                                    hyper=th, opt=topt, lr=LR,
                                    pairwise=pairwise)
    # The first AdaGrad step moves each weight by lr·g/(|g|+1e-8) ≈
    # lr·sign(g): entries whose gradient is within f32 noise of 0 may move
    # the other way, so the bound is in units of lr — all within 2·lr, and
    # all but a few entries within 1e-3·lr.
    diffs = np.concatenate([
        np.abs(a - b).ravel() for a, b in zip(
            tloss.tree_leaves(to_numpy(tnew)),
            jax.tree_util.tree_leaves(jax.device_get(jnew)))])
    assert diffs.max() <= 2 * LR + 1e-7
    assert (diffs > 1e-3 * LR).mean() < 1e-3


def test_padding_rows_carry_no_loss():
    """Labels, label mask and affinities of padded rows must not move the
    loss: ``mask*valid`` and ``W`` masked by the outer product of ``valid``.
    (Padded features still reach the loss through κ·H(p_i), exactly as in
    the reference, so they are left alone here.)"""
    cfg = tdnn.DNNConfig(input_dim=16, hidden_dim=32, n_hidden=1,
                         n_classes=39, dropout=0.0)
    params = to_torch(_params_np(jdnn.DNNConfig(**vars(cfg))))
    batch = _step_batch()
    dirty = {k: v.copy() for k, v in batch.items()}
    pad = ~dirty["valid"]
    dirty["label_mask"][pad] = 1.0
    dirty["y"][pad] = 0
    for z in range(2):
        dirty["W"][z][pad[z], :] = 7.0
        dirty["W"][z][:, pad[z]] = 5.0
    th = tloss.SSLHyper(**HYPER)
    a, ma = tstep.dnn_ssl_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, th)
    b, mb = tstep.dnn_ssl_loss(
        params, {k: torch.from_numpy(v) for k, v in dirty.items()}, cfg, th)
    assert a.item() == b.item()
    assert all(ma[k].item() == mb[k].item() for k in ma)


def test_one_ssl_step_with_block_layout_matches_reference(monkeypatch):
    """k=2 workers whose batch carries each worker's BlockLayout (the
    ``tile_*`` fields, one list length): the reference runs its
    block-sparse Pallas kernels (interpret mode) under its vmap, the port
    its block-sparse Function with the worker axis leading; loss, metrics
    and grads agree, and the layout really reaches the port's kernels."""
    from repro.api.registry import resolve_pairwise as jresolve
    from repro.core.metabatch import block_layout as jlayout
    from repro.kernels.tuning import TileSpec as JTileSpec
    from repro_torch.api.registry import resolve_pairwise
    from repro_torch.core.metabatch import block_layout as tlayout
    from repro_torch.kernels import graph_reg_bsp
    from repro_torch.kernels.tuning import TileSpec

    bt, P = 32, 96
    cfg = jdnn.DNNConfig(input_dim=16, hidden_dim=48, n_hidden=2,
                         n_classes=39, dropout=0.0)
    params = _params_np(cfg, seed=2)
    batch = _step_batch(P=P)
    rng = np.random.default_rng(9)
    for z in range(2):   # zero W outside a symmetric tile mask
        occ = rng.random((3, 3)) < 0.5
        occ = occ | occ.T | np.eye(3, dtype=bool)
        batch["W"][z] *= np.kron(occ, np.ones((bt, bt), np.float32))
    T = max(tlayout(w, bt).list_len for w in batch["W"])
    lays = [tlayout(w, bt, list_len=T).arrays() for w in batch["W"]]
    assert all(np.array_equal(a, b) for w, lay in zip(batch["W"], lays)
               for a, b in zip(lay, jlayout(w, bt, list_len=T).arrays()))
    for i, key in enumerate(tstep._TILE_KEYS):
        batch[key] = np.stack([lay[i] for lay in lays])
    assert not all(lay[6].all() for lay in lays)

    jgrads, jmet = jstep.dnn_ssl_grads(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=cfg,
        hyper=jloss.SSLHyper(**HYPER),
        pairwise=jresolve("blocksparse", tiles=JTileSpec(bi=bt, bc=16)))
    calls = []
    real = graph_reg_bsp.bsp_forward

    def spy(logp, W, rows, *a, **k):
        calls.append(tuple(rows.shape))
        return real(logp, W, rows, *a, **k)

    monkeypatch.setattr(graph_reg_bsp, "bsp_forward", spy)
    tgrads, tmet = tstep.dnn_ssl_grads(
        to_torch(params), {k: torch.from_numpy(v) for k, v in batch.items()},
        cfg=tdnn.DNNConfig(**vars(cfg)), hyper=tloss.SSLHyper(**HYPER),
        pairwise=resolve_pairwise("auto", tiles=TileSpec(bi=bt)))
    assert calls == [(2, T)]
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close(tmet[k].item(), float(jmet[k]))
    for a, b in zip(tloss.tree_leaves(to_numpy(tgrads)),
                    jax.tree_util.tree_leaves(jax.device_get(jgrads))):
        _close(a, b, rtol=1e-4)
