"""Phi-4-mini — dense GQA with RoPE + SwiGLU [arXiv:2412.08905]."""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=200064, rope_theta=1e4,
    block_pattern=(ATTN,), activation="swiglu", norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2412.08905",
)
