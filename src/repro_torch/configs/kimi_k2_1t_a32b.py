"""Kimi K2 — trillion-parameter MoE, 384 experts top-8, dense first layer
[arXiv:2501.kimi2 (paper-table)]. GQA per assignment (kv=8)."""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, rope_theta=5e4,
    block_pattern=(ATTN,), first_layer_dense=True,
    n_experts=384, top_k=8, moe_d_ff=2048, moe_every=1,
    moe_dispatch_groups=64,   # grouped dispatch (§Perf: -40% collective, -35% memory)
    activation="swiglu", norm="rmsnorm",
    source="arXiv:2501.kimi2",
)
