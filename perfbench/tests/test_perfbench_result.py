"""A run's last line, its checks, and the per-layer readers."""
import json

import pytest

from perfbench import run
from perfbench.harness import result, spec
from perfbench.harness.trace import Trace, group, short
from perfbench.tests.cells import prefill_cell, run_cpu

CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
H100 = dict(CPU, platform="gpu", kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("workload", ["qwen2-1.5b.prefill_2k",
                                      "qwen2-1.5b.prefill_32k"])
def test_untraced_line(workload, capsys):
    cell = prefill_cell(workload)
    out = run_cpu(cell)
    line, checks = run.result_line(cell, out, False, CPU)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(checks) == set(cell.limits)
    result.emit(line, checks)
    stdout, stderr = capsys.readouterr()
    last = json.loads(stdout.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    tail = stderr.strip().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)


def test_traced_line_reads_no_device_metric_on_the_cpu():
    cell = prefill_cell("qwen2-1.5b.prefill_2k")
    out = run_cpu(cell, trace=True)
    line, _ = run.result_line(cell, out, True, CPU)
    assert line["correct"] is True
    # Host-clock metrics only: no kernel ran on a card, and the CPU has
    # no peak in the table.
    assert set(line["metrics"]) == {"host_dispatch_ms.prefill"}
    assert line["device"]["busy_s"] == 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_judge():
    ok, checks = result.judge({"a": 0.1, "b": 0}, {"a": 0.2, "b": 0})
    assert ok and checks == {"a": {"value": 0.1, "limit": 0.2},
                             "b": {"value": 0, "limit": 0}}
    assert not result.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not result.judge({"a": float("nan")}, {"a": 0.2})[0]
    assert not result.judge({}, {"a": 0.2})[0]


def _trace():
    k11 = "void k11_wgmma::flash_fwd_wgmma_kernel<128>(x)"
    gemm = "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT"
    kernels = [(gemm, 0.0, 0.4), (k11, 0.4, 0.5), ("elementwise", 0.6, 0.9),
               (gemm, 1.0, 1.6), ("elementwise", 1.5, 1.8)]
    spans = [("request", 0.0, 1.0), ("first_token", 0.5, 0.6),
             ("request", 1.0, 2.0)]
    return Trace(kernels=kernels, window=(0.0, 2.0), spans=spans)


def test_trace_reduction():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(1.6)
    assert tr.group_s() == pytest.approx(
        {"matmul": 1.0, "flash_attention": 0.1, "other": 0.6})
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"first_token": 0.1, "request": 0.3})
    assert tr.top_ops()[0] == [short(_trace().kernels[0][0]), 1.0]
    assert group("reg_bwd_dlogp_classes") == "graph_reg"


def test_prefill_readers():
    ctx = {"kind": "prefill", "trace": _trace(), "units": 2,
           "unit_s": 0.5, "dispatch_s": [0.2, 0.4], "flops": 1e12,
           "k11_launches": 28, "batch": 4, "prompt_len": 2048,
           "peaks": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
           "config": {"n_heads": 12, "n_kv_heads": 2, "head_dim": 128}}
    read = {m: spec.metric_reader(m)(ctx) for m in (
        "host_dispatch_ms.prefill", "mfu.prefill", "device_ms.matmul.prefill",
        "device_ms.nonmatmul.prefill", "idle_share.prefill", "k11_roofline",
        "mfu.train", "idle_share.train")}
    assert read["host_dispatch_ms.prefill"] == pytest.approx(300.0)
    assert read["mfu.prefill"] == pytest.approx(100 * 1e12 / 0.5 / 989e12)
    assert read["device_ms.matmul.prefill"] == pytest.approx(500.0)
    assert read["device_ms.nonmatmul.prefill"] == pytest.approx(300.0)
    assert read["idle_share.prefill"] == pytest.approx(20.0)
    # 28 launches of 52.14 us at least, over 0.05 s of K11 a request.
    assert read["k11_roofline"] == pytest.approx(
        100 * 28 * 5.2138e-5 / 0.05, rel=1e-3)
    assert read["mfu.train"] is None and read["idle_share.train"] is None


def test_readers_find_nothing_without_kernels_or_peaks():
    ctx = {"kind": "prefill", "units": 1, "unit_s": 0.1, "flops": 1.0,
           "peaks": None, "dispatch_s": [],
           "trace": Trace(kernels=[], window=(0.0, 1.0), spans=[])}
    for m in ("mfu.prefill", "k11_roofline", "idle_share.prefill",
              "device_ms.matmul.prefill", "host_dispatch_ms.prefill"):
        assert spec.metric_reader(m)(ctx) is None, m


def test_peak_leaves_out_what_the_check_keeps():
    import torch

    from perfbench.harness import common
    from repro_torch.models.layers.attention import KVCache
    logits = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    stacked = KVCache.init(2, 9, 1, 4, torch.bfloat16, lead=(3,))
    layer = KVCache(stacked.k[0], stacked.v[0], stacked.positions[0],
                    stacked.valid[0])
    peak = common.Peak(torch.device("cpu"))
    # Views share their storage: each buffer counts once.
    peak.keep({"logits": logits, "last": logits[:, -1]},
              {"layers": [stacked, layer]})
    assert peak.held == (logits.nbytes + stacked.k.nbytes + stacked.v.nbytes
                         + stacked.positions.nbytes + stacked.valid.nbytes)
    assert peak.read() == 0


def test_set_up_splits_into_its_phases():
    from perfbench.harness import common
    s = common.SetUp(10.0)
    s.marks += [("a", 12.5), ("b", 13.0)]
    assert s.split() == {"a": 2.5, "b": 0.5}
