"""Llama-3.2-Vision-90B — dense decoder with gated cross-attention image
layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector is the stubbed frontend (DESIGN.md §3):
input_specs() supplies (B, 1601, 1280) patch embeddings; the in-model
projector maps them to d_model for the cross-attention KV."""
from repro_torch.models.config import ATTN, XATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, rope_theta=5e5,
    block_pattern=(ATTN, ATTN, ATTN, ATTN, XATTN),
    activation="swiglu", norm="rmsnorm",
    modality_tokens=1601, modality_dim=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
