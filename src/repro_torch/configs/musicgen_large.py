"""MusicGen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec codec (mel + conv encoder/decoder) is the
stubbed modality frontend: input_specs() supplies token ids from its 2048-entry
codebook directly (DESIGN.md §3)."""
from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048,
    block_pattern=(ATTN,), activation="gelu", norm="layernorm",
    source="arXiv:2306.05284",
)
