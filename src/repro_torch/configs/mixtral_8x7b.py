"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import ATTN_SWA, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, rope_theta=1e6, sliding_window=4096,
    block_pattern=(ATTN_SWA,),
    n_experts=8, top_k=2, moe_d_ff=14336, moe_every=1,
    moe_dispatch_groups=64,   # grouped dispatch (§Perf iter 2: no cross-shard cumsum)
    activation="swiglu", norm="rmsnorm",
    source="arXiv:2401.04088",
)
