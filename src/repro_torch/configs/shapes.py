"""Assigned input shapes and shape→config adaptation rules."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ATTN, ATTN_SWA, ModelConfig

LONG_CONTEXT_WINDOW = 8192  # sliding window used for long_500k on dense archs


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt an architecture config to an input shape.

    For ``long_500k`` every full-attention (ATTN) layer becomes sliding-window
    (ATTN_SWA, window 8192) — the sub-quadratic variant required by the brief;
    SSM/linear layers and natively-windowed archs are unchanged.  This keeps
    the decode state bounded (ring KV of `window` slots instead of 524k).
    """
    if shape.name != "long_500k":
        return cfg
    pattern = tuple(ATTN_SWA if k == ATTN else k for k in cfg.block_pattern)
    if pattern == cfg.block_pattern and cfg.sliding_window is not None:
        return cfg
    window = cfg.sliding_window or LONG_CONTEXT_WINDOW
    return dataclasses.replace(cfg, block_pattern=pattern,
                               sliding_window=window)
