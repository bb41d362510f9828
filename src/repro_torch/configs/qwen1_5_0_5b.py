"""Qwen1.5-0.5B — dense MHA (kv=16) with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    block_pattern=(ATTN,), activation="swiglu", norm="rmsnorm",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
