"""xLSTM-125M — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per assignment: xLSTM blocks carry their own up/down projections
(GeGLU inside the sLSTM block, pre-up-projection inside the mLSTM block)."""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    block_pattern=(SLSTM, MLSTM),
    activation="gelu", norm="layernorm",
    source="arXiv:2405.04517",
)
