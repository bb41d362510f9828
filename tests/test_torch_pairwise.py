"""The port's graph-construction kernels (K8, K9), the bare cross term (K10)
and the device graph path, against the reference.

Each test feeds the same numpy inputs, made from a seed, to the JAX
function and to the port; on the CPU the port's wrappers run their plain
versions, the reference's Pallas kernels run in interpret mode.

Tolerances:

* K8 (streaming top-k): d2 within rtol 1e-4, atol 1e-5, as the
  reference's own kernel test; indices equal except where the two picks
  are a near tie (their float64 distances lie within that tolerance of
  each other: float32 sums in another order may pick either).  On
  integer-valued inputs with duplicates every distance is exact, and the
  indices must equal ``lax.top_k``'s (ties to the lowest index).
* K9 (RBF block): rtol 1e-5, atol 1e-6, as the reference's kernel test.
* K10 (bare cross term): rtol 3e-5, as the reference's kernel test; its
  gradients against ``jax.grad`` of the reference's oracle at rtol 1e-5.
* Graph builders: sigma within rel 1e-6, W within rtol 1e-5, atol 1e-6;
  the edge sets equal.
* ``Experiment`` with ``construction="device"``: the same graph and plan,
  and per-epoch losses within rtol 1e-5 (``tests/test_torch_trainer.py``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.affinity as jaff  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.graph_reg import graph_reg_pairwise_pallas  # noqa: E402
from repro.kernels.pairwise import (knn_topk_pallas,  # noqa: E402
                                    rbf_affinity_pallas)
from repro.online import refresh as jrefresh  # noqa: E402
import repro_torch.core.affinity as taff  # noqa: E402
from repro_torch.kernels import graph_reg as gr  # noqa: E402
from repro_torch.kernels import ops, pairwise, ref  # noqa: E402
from repro_torch.online import refresh as trefresh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _xy(N, M, D, seed=0):
    rng = np.random.default_rng(seed + 7 * N + M + D)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = x if N == M else rng.normal(size=(M, D)).astype(np.float32)
    return x, y


def _tie_data(N, M, D, seed=0):
    """Integer-valued rows with duplicates: exact distances, many ties."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=(M, D)).astype(np.float32)
    y[M // 2:M // 2 + N // 4] = y[:N // 4]
    return y[:N].copy(), y


def _assert_idx_equal_but_near_ties(x, y, got, want, want_d2, rtol, atol):
    """Indices equal, except where the two picks' float64 distances lie
    within the d2 tolerance of each other."""
    r, c = np.nonzero(got != want)
    if len(r):
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        d_got = ((x64[r] - y64[got[r, c]]) ** 2).sum(1)
        d_want = ((x64[r] - y64[want[r, c]]) ** 2).sum(1)
        assert np.all(np.abs(d_got - d_want)
                      <= atol + rtol * np.abs(want_d2[r, c]))


# ------------------------------------------------------------- K8 top-k
@pytest.mark.parametrize("N,M,D,k", [(40, 40, 16, 5), (130, 257, 100, 10),
                                     (33, 65, 7, 3)])
def test_knn_topk_matches_reference_kernel(N, M, D, k):
    x, y = _xy(N, M, D)
    ex = N == M
    jd, ji = knn_topk_pallas(jnp.asarray(x), jnp.asarray(y), k,
                             exclude_self=ex, bi=32, bj=64, bd=32,
                             interpret=True)
    td, ti = ops.knn_topk(torch.tensor(x), torch.tensor(y), k,
                          exclude_self=ex)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    assert td.shape == ti.shape == (N, k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    _assert_idx_equal_but_near_ties(x, y, ti.numpy(), np.asarray(ji),
                                    np.asarray(jd), 1e-4, 1e-5)


@pytest.mark.parametrize("N,M,D,k", [(100, 100, 16, 40), (70, 150, 24, 64)])
def test_knn_topk_beyond_32_matches_reference_kernel(N, M, D, k):
    """k = 40 and 64: the reference's kernel takes any k ≤ M − 1; on the CPU
    the port's entry runs the plain version, which does too (``K_MAX``
    only picks the card's route)."""
    x, y = _xy(N, M, D)
    ex = N == M
    jd, ji = knn_topk_pallas(jnp.asarray(x), jnp.asarray(y), k,
                             exclude_self=ex, bi=32, bj=64, bd=32,
                             interpret=True)
    td, ti = ops.knn_topk(torch.tensor(x), torch.tensor(y), k,
                          exclude_self=ex)
    assert td.shape == ti.shape == (N, k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    _assert_idx_equal_but_near_ties(x, y, ti.numpy(), np.asarray(ji),
                                    np.asarray(jd), 1e-4, 1e-5)


@pytest.mark.parametrize("N,M,ex", [(120, 120, True), (60, 200, False),
                                    (60, 200, True)])
def test_knn_topk_exact_ties_match_lax_top_k(N, M, ex):
    x, y = _tie_data(N, M, 4)
    if ex and N == M:
        y = x
    jd, ji = jref.knn_topk_ref(jnp.asarray(x), jnp.asarray(y), 11,
                               exclude_self=ex)
    td, ti = pairwise.knn_topk(torch.tensor(x), torch.tensor(y), 11,
                               exclude_self=ex)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("chunk", [7, 64, 10_000])
@pytest.mark.parametrize("ties", [False, True])
def test_streamed_plain_version_equals_dense_oracle(chunk, ties):
    x, y = _tie_data(90, 150, 5) if ties else _xy(90, 150, 20)
    for a, b, ex in ((x, y, False), (x, x, True), (x, y, True)):
        a, b = torch.tensor(a), torch.tensor(b)
        sd, si = ref.knn_topk_stream_ref(a, b, 9, exclude_self=ex,
                                         chunk=chunk)
        dd, di = ref.knn_topk_ref(a, b, 9, exclude_self=ex)
        assert torch.equal(sd, dd) and torch.equal(si, di)


def test_knn_topk_refusals():
    x = torch.tensor(_xy(40, 40, 6)[0])
    with pytest.raises(ValueError, match="k must be"):
        ops.knn_topk(x, x, 40, exclude_self=True)
    with pytest.raises(ValueError, match="k must be"):
        ops.knn_topk(x, x, 0)
    with pytest.raises(ValueError, match="one device"):
        pairwise.knn_topk(x, torch.empty(40, 6, device="meta"), 3)
    with pytest.raises(ValueError, match="one device"):
        pairwise.rbf_affinity(x, torch.empty(40, 6, device="meta"), 1.0)
    with pytest.raises(ValueError, match="backend"):
        taff.knn_edges(x.numpy(), 3, backend="gpu")


def test_k_max_is_the_kernels_limit():
    src = (ROOT / pairwise.SOURCE).read_text()
    assert int(re.search(r"kKMax = (\d+);", src).group(1)) == pairwise.K_MAX


@pytest.mark.parametrize("k", [1, 10, 256, 257, 300, 1000])
def test_knn_route_and_list_bytes_follow_the_source(k):
    """K8 keeps its lists in shared memory up to kKMax and in global
    memory past it, by k alone.  A (d2, index) pair of the lists takes the
    source's kListEntryBytes: shared memory holds 128 rows of them on the
    shared route only, and the workspace holds the segments' partial lists
    only when there is more than one segment; the (N, k) outputs are the
    pairs of the final lists."""
    src = (ROOT / pairwise.SOURCE).read_text()
    k_max = int(re.search(r"kKMax = (\d+);", src).group(1))
    assert re.search(r"k > kKMax \? launch_knn<true,", src)
    assert pairwise.route(k) == ("shared" if k <= k_max else "global")
    entry = re.search(r"kListEntryBytes = sizeof\(float\) \+ sizeof\(int\);",
                      src)
    assert entry and pairwise.LIST_ENTRY_BYTES == 4 + 4
    N, M = 3, k + 1
    plan = pairwise.knn_plan(N, M, 4, k, same=False, n_sm=132)
    lists = plan["dynamic_smem_bytes"] - pairwise.knn_plan(
        N, M, 4, k_max + 1, same=False, n_sm=132)["dynamic_smem_bytes"]
    assert lists == (pairwise.D2_ROWS * k * 8 if k <= k_max else 0)
    packed = 4 * pairwise.D2_K * (128 + -(-M // 128) * 128)
    assert plan["workspace_bytes"] == packed + (
        plan["segments"] * N * k * 8 if plan["segments"] > 1 else 0)
    x, y = (torch.tensor(a) for a in _xy(N, M, 4))
    d2, idx = pairwise.knn_topk(x, y, k)
    assert (d2.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert d2.shape == idx.shape == (N, k)
    assert d2.nbytes + idx.nbytes == N * k * (4 + 4)


#: The launch plans' constants in the sources, by name: (file, name in
#: the source, the mirror's value in :mod:`repro_torch.kernels.pairwise`).
_PLAN_CONSTANTS = {
    "rows": ("d2_tile.cuh", "kD2Rows", pairwise.D2_ROWS),
    "cols": ("d2_tile.cuh", "kD2Cols", pairwise.D2_COLS),
    "slab": ("d2_tile.cuh", "kD2K", pairwise.D2_K),
    "stages": ("d2_tile.cuh", "kD2Stages", pairwise.D2_STAGES),
    "threads": ("d2_tile.cuh", "kD2Threads", pairwise.D2_THREADS),
    "cand_cap": ("pairwise.cu", "kCandCap", pairwise.CAND_CAP),
    "max_segments": ("pairwise.cu", "kMaxSegments", pairwise.MAX_SEGMENTS),
    "min_segment_tiles": ("pairwise.cu", "kMinSegmentTiles",
                          pairwise.MIN_SEGMENT_TILES),
}


@pytest.mark.parametrize("name", sorted(_PLAN_CONSTANTS))
def test_launch_plan_mirror_constants_follow_the_source(name):
    fname, const, value = _PLAN_CONSTANTS[name]
    src = (ROOT / "src/repro_torch/csrc" / fname).read_text()
    assert int(re.search(rf"constexpr int {const} = (\d+);", src).group(1)) \
        == value


def test_launch_plan_mirror_byte_cap_follows_the_source():
    src = (ROOT / pairwise.SOURCE).read_text()
    shift = re.search(r"kSegmentBytesCap = 256ll << (\d+);", src)
    assert shift and pairwise.SEGMENT_BYTES_CAP == 256 << int(shift.group(1))


@pytest.mark.parametrize("N,M,k,n_sm,segments", [
    (20000, 20000, 10, 132, 5),     # the corpus: 785 blocks of 32 tiles
    (2000, 2000, 1000, 132, 4),     # global route, 16 column tiles
    (4000, 4000, 300, 132, 4),
    (300, 700, 10, 132, 1),         # under 2 x kMinSegmentTiles tiles
    (300, 4100, 11, 132, 7),        # 33 tiles: 8 wanted, 5 a segment -> 7
    (200_000, 200_000, 1000, 132, 1),   # the partial lists' byte cap
])
def test_knn_launch_plan_mirror(N, M, k, n_sm, segments):
    """The mirror of K8's host plan (``knn_plan`` in the source): segments
    fill the card, each ≥ kMinSegmentTiles tiles, none empty, and the
    partial lists stay under the byte cap; no other count of segments has
    an SM walk fewer tiles."""
    plan = pairwise.knn_plan(N, M, 351, k, same=N == M, n_sm=n_sm)
    assert plan["segments"] == segments
    tiles = -(-M // 128)
    assert (plan["segments"] - 1) * plan["seg_tiles"] < tiles
    assert plan["segments"] * plan["seg_tiles"] >= tiles
    if segments > 1:
        assert plan["seg_tiles"] >= pairwise.MIN_SEGMENT_TILES
        assert segments * N * k * 8 <= pairwise.SEGMENT_BYTES_CAP
    strips = -(-N // 128)
    walk = -(-strips * segments // n_sm) * plan["seg_tiles"]
    assert all(walk <= -(-strips * s // n_sm) * -(-tiles // s)
               for s in range(1, pairwise.MAX_SEGMENTS + 1)
               if s == 1 or (tiles // s >= pairwise.MIN_SEGMENT_TILES
                             and s * N * k * 8 <= pairwise.SEGMENT_BYTES_CAP))
    assert plan["dynamic_smem_bytes"] <= 232_448      # an H100 block's most


@pytest.mark.parametrize("n,rows", [(2042, 128), (2176, 64), (2048, 128),
                                    (1000, 64)])
def test_rbf_launch_plan_mirror(n, rows):
    """K9's tile rows: 64 where each SM then runs fewer rows of tiles
    (2176² is 289 tiles of 128² on 132 SMs, 3 a SM; 578 of 64 × 128, 5)."""
    plan = pairwise.rbf_plan(n, n, 351, same=True, n_sm=132)
    assert plan["rows_per_block"] == rows
    assert plan["workspace_bytes"] == 4 * 352 * (-(-n // 128) * 128)
    assert 352 % pairwise.D2_K == 0     # 351 features pad to 352


@pytest.mark.parametrize("segments", [1, 2, 3, 5])
@pytest.mark.parametrize("ex", [False, True])
def test_segment_merge_rule_matches_stream_and_reference(segments, ex):
    """K8's split: per-segment top-k lists of column tiles (16 wide here,
    so 160 columns make 10 tiles), merged by rank in (d2, index) order,
    on integer inputs whose duplicate rows put exact ties on both sides of
    every segment boundary: the lists equal the streamed plain version's
    and the reference's Pallas kernel's (interpret mode) exactly."""
    rng = np.random.default_rng(segments)
    y = rng.integers(0, 3, size=(160, 4)).astype(np.float32)
    y[80:120] = y[:40]
    y[150:] = y[10:20]
    x = y[:48].copy()
    xt, yt = torch.tensor(x), torch.tensor(y)
    k = 9
    got = ref.knn_topk_segments_ref(xt, yt, k, exclude_self=ex,
                                    segments=segments, tile=16)
    stream = ref.knn_topk_stream_ref(xt, yt, k, exclude_self=ex)
    assert torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1])
    jd, ji = knn_topk_pallas(jnp.asarray(x), jnp.asarray(y), k,
                             exclude_self=ex, bi=16, bj=32, bd=8,
                             interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))


def test_segment_merge_keeps_unfilled_slots_last():
    """Segments shorter than k pad their lists with (EMPTY, -1); the merge
    ranks every real pair first and hands equal pads to the lower list, so
    each output slot is written once."""
    d2 = torch.tensor([[[1.0, ref.EMPTY, ref.EMPTY]],
                       [[0.5, 2.0, ref.EMPTY]]])
    idx = torch.tensor([[[4, -1, -1]], [[9, 7, -1]]], dtype=torch.int32)
    d, i = ref.merge_segment_lists(d2, idx, 3)
    assert d.tolist() == [[0.5, 1.0, 2.0]] and i.tolist() == [[9, 4, 7]]
    d, i = ref.merge_segment_lists(d2[:, :, :2].clone(), idx[:, :, :2].clone(),
                                   2)
    assert d.tolist() == [[0.5, 1.0]] and i.tolist() == [[9, 4]]
    pads = ref.merge_segment_lists(
        torch.full((3, 1, 2), ref.EMPTY),
        torch.full((3, 1, 2), -1, dtype=torch.int32), 2)
    assert pads[1].tolist() == [[-1, -1]]


# ------------------------------------------------------------- K9 RBF
@pytest.mark.parametrize("N,M,D", [(32, 32, 16), (64, 64, 351),
                                   (130, 70, 64), (33, 257, 100),
                                   (128, 128, 256)])
def test_rbf_affinity_matches_reference_kernel(N, M, D):
    rng = np.random.default_rng(N + M + D)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.normal(size=(M, D)).astype(np.float32)
    want = rbf_affinity_pallas(jnp.asarray(x), jnp.asarray(y), 2.0,
                               interpret=True)
    got = ops.rbf_affinity(torch.tensor(x), torch.tensor(y), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- K10 cross term
def _logp_w(B, C, seed=0):
    rng = np.random.default_rng(seed + B + C)
    logits = rng.normal(size=(B, C)).astype(np.float32) * 2.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    W = (np.abs(rng.normal(size=(B, B))) * (rng.random((B, B)) < 0.2))
    return logp, W.astype(np.float32)


@pytest.mark.parametrize("B,C", [(16, 32), (64, 39), (130, 17), (33, 100)])
def test_pairwise_cross_term_matches_reference_kernel(B, C):
    logp, W = _logp_w(B, C)
    want = graph_reg_pairwise_pallas(jnp.asarray(logp), jnp.asarray(W),
                                     interpret=True)
    got = ops.graph_reg_pairwise(torch.tensor(logp), torch.tensor(W))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)
    assert float(gr.reg_pairwise(torch.tensor(logp), torch.tensor(W))) == \
        float(got)


@pytest.mark.parametrize("B,C", [(48, 39), (33, 10)])
def test_pairwise_cross_term_gradients_match_reference(B, C):
    logp, W = _logp_w(B, C, seed=1)
    jg = jax.grad(jref.graph_reg_pairwise_ref, argnums=(0, 1))(
        jnp.asarray(logp), jnp.asarray(W))
    lp = torch.tensor(logp, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    ops.graph_reg_pairwise(lp, w).backward()
    for got, want in zip((lp.grad, w.grad), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------- graph builders
def _assert_same_graph(tg, jg):
    assert tg.sigma == pytest.approx(jg.sigma, rel=1e-6)
    assert tg.k == jg.k
    np.testing.assert_array_equal(tg.W.indptr, jg.W.indptr)
    np.testing.assert_array_equal(tg.W.indices, jg.W.indices)
    np.testing.assert_allclose(tg.W.toarray(), jg.W.toarray(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,D", [(120, 16), (300, 40)])
def test_device_affinity_graph_matches_reference(n, D):
    X = np.random.default_rng(n).normal(size=(n, D)).astype(np.float32)
    jg = jaff.build_affinity_graph(X, k=5, backend="device")
    tg = taff.build_affinity_graph(X, k=5, backend="device", device="cpu")
    _assert_same_graph(tg, jg)
    # The host backend of the port is untouched by the device argument.
    th = taff.build_affinity_graph(X, k=5, device="cpu")
    assert (th.W != jaff.build_affinity_graph(X, k=5).W).nnz == 0


@pytest.mark.parametrize("bandwidth", ["global", "per_node"])
def test_embedding_knn_graph_matches_reference(bandwidth):
    E = np.random.default_rng(3).normal(size=(150, 12)).astype(np.float32)
    jg = jrefresh.embedding_knn_graph(E, k=6, backend="device",
                                      bandwidth=bandwidth)
    tg = trefresh.embedding_knn_graph(E, k=6, backend="device",
                                      bandwidth=bandwidth, device="cpu")
    _assert_same_graph(tg, jg)
    th = trefresh.embedding_knn_graph(E, k=6, bandwidth=bandwidth)
    assert trefresh.edge_churn(th, tg) == 0.0
    assert trefresh.edge_set(tg) == jrefresh.edge_set(jg)
    d2, idx = trefresh.embedding_topk_device(torch.tensor(E), 6)
    jd, ji = jrefresh.embedding_topk_device(jnp.asarray(E), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="bandwidth"):
        trefresh.embedding_knn_graph(E, bandwidth="learned")


# ------------------------------------------------------------- the slice
def test_experiment_with_device_graph_matches_reference(monkeypatch):
    """Two epochs of ``Experiment`` with ``construction="device"`` on the
    CPU (plain K8, then the fused regularizer) against the reference's
    ``Experiment`` from the same config document and initial params,
    dropout 0."""
    import repro.train.trainer as jtrainer
    import repro_torch.train.trainer as ttrainer
    from repro.api import Experiment as JExperiment
    from repro.api import ExperimentConfig as JConfig
    from repro.models.dnn import init_dnn as jinit
    from repro_torch.api import (BatchConfig, DataConfig, Experiment,
                                 ExperimentConfig, GraphConfig, TrainConfig)
    from repro_torch.convert import to_torch

    cfg = ExperimentConfig(
        data=DataConfig(n=1200, n_classes=8, input_dim=16, manifold_dim=4),
        graph=GraphConfig(construction="device"),
        train=TrainConfig(hidden_dim=32, n_hidden=2, n_epochs=2,
                          dropout=0.0),
        batch=BatchConfig(batch_size=128))
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
    pairwise.knn_topk.launches = 0
    texp = Experiment(cfg, device="cpu")
    tres = texp.run()
    assert pairwise.knn_topk.launches == 0        # plain version on the CPU
    _assert_same_graph(texp.graph, jexp.graph)
    assert len(texp.plan.meta_batches) == len(jexp.plan.meta_batches)
    for a, b in zip(texp.plan.meta_batches, jexp.plan.meta_batches):
        np.testing.assert_array_equal(a, b)
    assert len(tres.history) == len(jres.history) == 2
    for trow, jrow in zip(tres.history, jres.history):
        for key in ("loss/total", "loss/supervised", "loss/graph",
                    "loss/l2"):
            np.testing.assert_allclose(trow[key], jrow[key], rtol=1e-5)
        assert abs(trow["eval/acc"] - jrow["eval/acc"]) <= 0.01
