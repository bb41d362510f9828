"""Model configuration covering all assigned architecture families.

One ``ModelConfig`` describes any of: dense GQA transformer, MoE, SSM
(xLSTM), hybrid (Mamba+attention+MoE), VLM (interleaved cross-attention) and
audio decoder.  Layer heterogeneity is expressed with a repeating
``block_pattern`` (a "super-block"): the full stack is
``block_pattern × n_superblocks`` which lets the forward pass ``lax.scan``
over super-blocks (small HLO even for 100-layer models).
"""
from __future__ import annotations

import dataclasses

# Layer kinds usable inside a block pattern.
ATTN = "attn"            # causal self-attention + FFN
ATTN_SWA = "attn_swa"    # sliding-window self-attention + FFN
XATTN = "xattn"          # cross-attention (to modality embeddings) + FFN
MAMBA = "mamba"          # Mamba SSM mixer + FFN
SLSTM = "slstm"          # xLSTM sLSTM block (post-up-projection)
MLSTM = "mlstm"          # xLSTM mLSTM block (pre-up-projection)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    head_dim: int | None = None      # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None        # window for ATTN_SWA layers
    # --- layer pattern ---
    block_pattern: tuple[str, ...] = (ATTN,)  # repeated n_layers/len times
    first_layer_dense: bool = False  # MoE archs with a dense first layer (kimi)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None      # expert hidden dim (default d_ff)
    moe_every: int = 1               # MoE FFN on layers where idx % moe_every == 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch_groups: int = 0     # 0 = global dispatch; G = grouped (GShard)
    # --- SSM / Mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- norms / activations ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "swiglu"       # swiglu | gelu | relu
    tie_embeddings: bool = False
    # --- modality frontend stub (vlm / audio) ---
    modality_tokens: int = 0         # #frontend embeddings per example
    modality_dim: int = 0            # frontend embedding dim (projected to d_model)
    # --- misc ---
    remat_policy: str = "full"       # full | dots | none (superblock scan)
    dtype: str = "bfloat16"
    max_seq_len: int = 1 << 20
    source: str = ""                 # citation

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}")
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> list[str]:
        return list(self.block_pattern) * self.n_superblocks

    def moe_layer(self, idx_in_block: int) -> bool:
        """Whether the FFN at pattern position ``idx_in_block`` is MoE."""
        return self.is_moe and (idx_in_block % self.moe_every == 0)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d                    # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d               # lm_head
        total += d                                     # final norm
        if self.modality_tokens:
            total += self.modality_dim * d             # frontend projector
        for li, kind in enumerate(self.layer_kinds()):
            if kind in (ATTN, ATTN_SWA, XATTN):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o + d                # + norm
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
                if kind == XATTN:
                    total += d                         # extra norm + gate
                total += d + self._ffn_params(li)      # ffn norm + ffn
            elif kind == MAMBA:
                di = self.mamba_expand * d
                dtr = max(d // 16, 1)
                total += d * 2 * di                    # in_proj (x, z)
                total += di * self.mamba_d_conv        # depthwise conv
                total += di * (dtr + 2 * self.mamba_d_state)  # x -> dt,B,C
                total += dtr * di + di                 # dt_proj
                total += di * self.mamba_d_state + di  # A_log, D
                total += di * d + d                    # out_proj + norm
                total += d + self._ffn_params(li)
            elif kind in (SLSTM, MLSTM):
                # xLSTM blocks: 4 gates worth of projections + up/down proj.
                if kind == SLSTM:
                    total += 4 * (d * d + self.n_heads * self.hd_x * self.hd_x) + d
                    pf = 4 * d // 3
                    total += d * 2 * pf + pf * d       # GeGLU up/down (4/3 factor)
                else:
                    di = 2 * d
                    total += d * 2 * di                # up proj (x, z)
                    total += 3 * di * di // self.n_heads  # q,k,v per-head (approx)
                    total += 2 * di                    # i,f gate projections (approx)
                    total += di * d                    # down proj
                total += d                             # norm
            else:
                raise ValueError(kind)
        return int(total)

    @property
    def hd_x(self) -> int:
        return self.d_model // self.n_heads

    def _ffn_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.d_ff == 0:
            return 0
        pattern_pos = layer_idx % max(len(self.block_pattern), 1)
        if self.is_moe and self.moe_layer(pattern_pos):
            eff = self.moe_d_ff or self.d_ff
            mats = 3 if self.activation == "swiglu" else 2
            return self.n_experts * mats * d * eff + d * self.n_experts  # + router
        mats = 3 if self.activation == "swiglu" else 2
        return mats * d * self.d_ff

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts instead of all)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        eff = self.moe_d_ff or self.d_ff
        mats = 3 if self.activation == "swiglu" else 2
        per_expert = mats * self.d_model * eff
        n_moe_layers = sum(
            1 for li, k in enumerate(self.layer_kinds())
            if k in (ATTN, ATTN_SWA, XATTN, MAMBA)
            and self.moe_layer(li % len(self.block_pattern))
            and not (self.first_layer_dense and li == 0)
        )
        total -= n_moe_layers * per_expert * (self.n_experts - self.top_k)
        return int(total)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 super-block-lengths of layers, tiny dims."""
        pat_len = len(self.block_pattern)
        small = dict(
            name=self.name + "-smoke",
            n_layers=2 * pat_len if pat_len > 1 else 2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=None if self.moe_d_ff is None else min(self.moe_d_ff, 128),
            sliding_window=None if self.sliding_window is None else 64,
            modality_tokens=min(self.modality_tokens, 16),
            modality_dim=min(self.modality_dim, 64) if self.modality_dim else 0,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
