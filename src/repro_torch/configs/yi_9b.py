"""Yi-9B — llama-architecture dense GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, rope_theta=5e6,
    block_pattern=(ATTN,), activation="swiglu", norm="rmsnorm",
    source="arXiv:2403.04652",
)
