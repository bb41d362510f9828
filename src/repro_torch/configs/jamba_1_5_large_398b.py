"""Jamba-1.5-Large — hybrid Mamba+attention (1:7) with MoE 16e top-2 on
alternate layers [arXiv:2403.19887]. Attention layers use a sliding-window
ring cache in long-context decode; Mamba layers carry O(1) state."""
from repro_torch.models.config import ATTN, MAMBA, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536,
    block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    n_experts=16, top_k=2, moe_d_ff=24576, moe_every=2,
    moe_dispatch_groups=64,   # grouped dispatch (§Perf)
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    activation="swiglu", norm="rmsnorm",
    source="arXiv:2403.19887",
)
