"""The MoE cell's files (``mixtral-8x7b.prefill_2k``): its loop on the
CPU at ``cells.tiny`` sizes (the experts' count, top-k and dtype kept),
its counts, its readers, and how it sits in BENCHMARK.json."""
import json

import pytest

from perfbench.harness import prefill_moe, result
from perfbench.tests.cells import BENCH, ROOT, run_cpu, tiny
from perfbench.tests.test_perfbench_spans import _ctx, _put, _request

spans = pytest.importorskip("repro_torch.spans")

CELL = "mixtral-8x7b.prefill_2k"
DENSE = ["qwen2-1.5b.prefill_2k", "phi4-mini-3.8b.prefill_2k",
         "qwen2-1.5b.prefill_32k"]
NEW_METRICS = ("device_ms.moe.prefill", "moe_gemm_roofline",
               "moe_permute_roofline")
PEAK = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _cell():
    from perfbench.harness import spec
    return tiny(spec.load_cell(CELL, ROOT), prompt_len=64,
                min_request_s=0.05)


def _reader(name):
    from perfbench.harness import spec
    return spec.metric_reader(name)


def _flops():
    import importlib.util
    s = importlib.util.spec_from_file_location(
        "perfbench_test_moe_flops", BENCH / "count" / "moe_flops.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def record():
    spans.clear()
    yield
    spans.clear()


def test_tiny_cell_keeps_the_experts():
    c = _cell().config
    assert (c["n_experts"], c["top_k"], c["dtype"]) == (8, 2, "bfloat16")


def test_sound_run_is_correct_and_the_control_is_not():
    cell = _cell()
    out = run_cpu(cell, control=True)
    assert result.judge(out["numbers"], cell.limits)[0], out["numbers"]
    assert out["numbers"]["dropped"] == 0
    assert not result.judge(out["control_numbers"], cell.limits)[0], \
        out["control_numbers"]
    assert set(out["look"]["own_routes"]) == set(out["numbers"])


@pytest.mark.parametrize("fault", prefill_moe.FAULTS)
def test_a_broken_prefill_is_not_correct(fault):
    cell = _cell()
    out = run_cpu(cell, faults=(fault,))
    assert not result.judge(out["numbers"], cell.limits)[0], out["numbers"]
    if fault == "capacity_drop":
        assert out["numbers"]["dropped"] > 0


def test_the_program_config_is_held_to_the_file():
    from perfbench.harness import spec
    c = spec.load_cell(CELL, ROOT).config
    cfg = prefill_moe.program_config(c, strict=True)
    assert (cfg.n_layers, cfg.moe_d_ff, cfg.n_experts, cfg.top_k) == \
        (16, 14336, 8, 2)
    with pytest.raises(ValueError, match="not the configuration file's"):
        prefill_moe.program_config(dict(c, top_k=1), strict=True)


def test_counts_of_a_hand_sized_layer():
    mf = _flops()
    c = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "n_experts": 4, "top_k": 2,
         "vocab_size": 10, "dtype": "bfloat16"}
    # QKV 8 -> (2 + 2) * 4 and out 8 -> 8: 2 * (128 + 64) a token.
    assert mf.attn_proj_flops(c) == 384
    # Router 2 * 8 * 4, two experts of 6 * 8 * 16.
    assert mf.expert_flops(c) == 64 + 2 * 768
    # 3 tokens (one sequence): 3 kept pairs of 4 * 4 * 2 heads, the head
    # 2 * 8 * 10 a position.
    assert mf.prefill_flops(c, 1, 3) == 3 * (384 + 1600) + 6 * 32 + 3 * 160
    # Three expert matrices of 8 x 16, six rows in and out of 8, bf16.
    assert mf.experts_bound_s(c, 3, {"bf16_flops": 1.0,
                                     "hbm_bytes_per_s": 1e12}) == 6 * 8 * 16 * 6
    assert mf.experts_bound_s(c, 3, {"bf16_flops": 1e15,
                                     "hbm_bytes_per_s": 1.0}) == \
        (3 * 4 * 8 * 16 + 2 * 6 * 8) * 2
    assert mf.dispatch_bytes(c, 3) == 6 * 8 + 3 * 16 + 6 * 16 + 6 * 4 + 32
    assert mf.combine_bytes(c, 3) == 6 * 16 + 6 * 8 + 3 * 16


def test_counts_of_the_cell():
    """The cell's arithmetic at 16 layers, 4 x 2,048 tokens: 83.9 + 704.6
    MFLOP a token and layer (and the router's 0.07), 2.20 TFLOP of
    attention, 2.15 of head, ~402 MB of K12 and K13 a layer."""
    from perfbench.harness import spec
    mf = _flops()
    c = spec.load_cell(CELL, ROOT).config
    assert mf.attn_proj_flops(c) == pytest.approx(83.9e6, rel=1e-3)
    assert mf.expert_flops(c) == pytest.approx(704.6e6 + 65536, rel=1e-4)
    total = mf.prefill_flops(c, 4, 2048)
    assert total == pytest.approx(107.7e12, rel=2e-3)
    per_layer = mf.dispatch_bytes(c, 8192) + mf.combine_bytes(c, 8192)
    assert per_layer == pytest.approx(402e6, rel=5e-3)


def test_new_readers_read_nothing_on_a_dense_cells_context():
    ctx = dict(_ctx(_request(1.0)), peaks=PEAK, config={}, batch=1,
               prompt_len=1, units=1)
    assert _reader("device_ms.rope.prefill")(ctx) is not None
    for name in NEW_METRICS:
        assert _reader(name)(ctx) is None, name


def _moe_request(t):
    """One request at host time t: a layer with K11 (the clock's anchor),
    an ``ffn.moe`` span [.5, .9] with its expert products' ``ffn.mlp``
    [.6, .8] inside, and a dense layer's ``ffn.mlp`` [.92, .98] outside;
    kernels: K11, the dispatch, two GEMMs around a SiLU, the combine, the
    dense MLP's GEMM and SiLU."""
    sid = round(t * 100)
    _put("prefill", sid, sid, None, t, t + 1, dev=(t, t + 1), anchor_err=1e-6)
    moe = sid + 3
    for k, (name, a, b, parent) in enumerate([
            ("kernel.flash_attention", 0.1, 0.2, sid),
            ("kernel.flash_attention", 0.25, 0.3, sid),
            ("ffn.moe", 0.5, 0.9, sid), ("moe.route", 0.5, 0.55, moe),
            ("kernel.moe_dispatch", 0.55, 0.6, moe),
            ("ffn.mlp", 0.6, 0.8, moe),
            ("kernel.moe_combine", 0.8, 0.85, moe),
            ("ffn.mlp", 0.92, 0.98, sid)], start=1):
        _put(name, sid + k, sid, parent, t + a, t + b, dev=(t + a, t + b))
    return [(n, t + a, t + b) for n, a, b in [
        ("flash_fwd_wgmma", 0.1, 0.2), ("flash_fwd_wgmma", 0.25, 0.3),
        ("softmax", 0.5, 0.52), ("moe_dispatch_kernel", 0.55, 0.58),
        ("cutlass_grouped_gemm", 0.6, 0.7), ("silu", 0.7, 0.72),
        ("cutlass_grouped_gemm", 0.72, 0.78),
        ("moe_combine_kernel<bf16>", 0.8, 0.84),
        ("sm90_xmma_gemm_bf16", 0.92, 0.96), ("silu", 0.96, 0.97)]]


def test_new_readers_on_a_moe_request():
    mf = _flops()
    c = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "n_experts": 4, "top_k": 2,
         "vocab_size": 10, "dtype": "bfloat16"}
    ctx = dict(_ctx(_moe_request(1.0)), peaks=PEAK, config=c, batch=1,
               prompt_len=3, units=1)
    # Busy inside ffn.moe: .02 + .03 + .10 + .02 + .06 + .04 s.
    assert _reader("device_ms.moe.prefill")(ctx) == \
        pytest.approx(270.0)
    assert _reader("moe_gemm_roofline")(ctx) == pytest.approx(
        100.0 * mf.experts_bound_s(c, 3, PEAK) / 0.16)
    assert _reader("moe_permute_roofline")(ctx) == pytest.approx(
        100.0 * mf.permute_bound_s(c, 3, PEAK) / 0.07)
    # The activation of both layers: SiLU inside each ``ffn.mlp``.
    assert _reader("device_ms.swiglu.prefill")(ctx) == pytest.approx(30.0)


def test_the_cell_is_added_and_the_dense_cells_keep_their_entries():
    """The cell's entries come last in their lists; the dense cells'
    metrics list them first and the MoE cell after them (its expert
    products' ``ffn.mlp`` spans give ``device_ms.swiglu.prefill`` its
    activation too)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["configs"][-1]["name"] == "mixtral-8x7b"
    assert [w["name"] for w in spec["workloads"]] == DENSE + [CELL]
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert [m["name"] for m in spec["per_layer"][-3:]] == list(NEW_METRICS)
    for m in metrics:
        cells = m.get("workloads")
        if cells is None or m["name"] in NEW_METRICS:
            continue
        dense = [w for w in cells if w != CELL]
        assert cells == dense + ([CELL] if CELL in cells else []), m["name"]
        assert CELL in cells, m["name"]
    for m in spec["per_layer"][-3:]:
        assert m["workloads"] == [CELL]
