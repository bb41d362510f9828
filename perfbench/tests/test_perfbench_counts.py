"""The FLOP and byte counts against hand counts at two shapes."""
import json

import pytest

from perfbench.count import flops
from perfbench.tests.cells import BENCH

H100 = flops.peaks("NVIDIA H100 80GB HBM3")
#: A decoder small enough to count by hand: d 8, 2 heads on 1 KV head of 4,
#: SwiGLU of 16, vocabulary 10, one layer.
HAND = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
            d_ff=16, vocab_size=10)


def qwen2():
    return json.loads((BENCH / "configs" / "qwen2-1.5b.json").read_text())


def test_hand_sized_decoder():
    # A token of the layer: q, k, v 8·(2+1+1)·4 = 128, out 2·4·8 = 64,
    # SwiGLU 3·8·16 = 384 multiply-adds: 1,152 FLOPs; three tokens 3,456.
    # Attention: 6 kept pairs, 4·4 FLOPs a pair and head, 2 heads: 192.
    # Head over 3 positions: 2·8·10·3 = 480.
    assert flops.layer_matmul_flops(HAND) == 1152
    assert flops.attention_flops(HAND, 1, 3) == 192
    assert flops.prefill_flops(HAND, 1, 3) == 3456 + 192 + 480
    # Training: forward and twice that backward, the head also over the
    # sequence's pooled state (4 positions).
    assert flops.train_step_flops(HAND, 1, 3) == 3 * (3456 + 192 + 640)


def test_qwen2_prefill_2k():
    layer = 2 * (1536 * (12 + 4) * 128 + 12 * 128 * 1536 + 3 * 1536 * 8960)
    assert flops.layer_matmul_flops(qwen2()) == layer == 93_585_408
    pairs = 2048 * 2049 // 2
    want = (layer * 28 * 4 * 2048 + 4 * 128 * 12 * pairs * 4 * 28
            + 2 * 1536 * 151936 * 4 * 2048)
    assert flops.prefill_flops(qwen2(), 4, 2048) == want
    assert want == pytest.approx(2.673e13, rel=1e-3)


def test_qwen2_train_4k_step():
    assert flops.train_step_flops(qwen2(), 16, 4096) == pytest.approx(
        6.763e14, rel=1e-3)


@pytest.mark.parametrize("cfg, batch, T, ms, by", [
    ("qwen2-1.5b", 4, 2048, 0.05214, "operations"),
    ("phi4-mini-3.8b", 4, 2048, 0.10428, "operations"),
    ("qwen2-1.5b", 1, 32768, 3.3372, "operations")])
def test_k11_bound(cfg, batch, T, ms, by):
    c = json.loads((BENCH / "configs" / f"{cfg}.json").read_text())
    ops = 4 * c["head_dim"] * c["n_heads"] * T * (T + 1) // 2 * batch
    bytes_ = (2 * c["n_heads"] + 2 * c["n_kv_heads"]) * c["head_dim"] \
        * batch * T * 2
    assert flops.k11_ops(c, batch, T) == ops
    assert flops.k11_bytes(c, batch, T) == bytes_
    bound = flops.k11_bound_s(c, batch, T, H100)
    assert 1e3 * bound == pytest.approx(ms, rel=1e-3)
    assert (ops / H100["bf16_flops"] >= bytes_ / H100["hbm_bytes_per_s"]) \
        == (by == "operations")


def test_unknown_device_has_no_peaks():
    assert flops.peaks("a CPU") is None
