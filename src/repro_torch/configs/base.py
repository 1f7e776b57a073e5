"""Model configuration schema shared by all 10 assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl M-RoPE (3-section rotary)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_logit_softcap: Optional[float] = None
    # norms / activations
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_norms: bool = False         # grok-1: a norm after each sublayer too
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    embed_scale: float = 1.0         # the embedded input times this
    logit_scale: float = 1.0         # the logits times this
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN residual branch
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    moe_renormalize: bool = True     # the top-k gates over their own sum
    moe_dropless: bool = False       # no token past an expert's capacity
    moe_shard: str = "auto"           # ep | tp | auto (see models/moe.py)
    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # hybrid (recurrentgemma): repeating temporal-block pattern
    pattern: Tuple[str, ...] = ()    # e.g. ("R", "R", "A")
    window: int = 2048               # local-attention window
    rglru_dim: int = 0               # recurrence width (= d_model usually)
    conv_width: int = 4
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500
    max_target_positions: int = 448
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # distribution hints
    vocab_pad_to: int = 256
    # sub-quadratic? (long_500k eligibility)
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def validate(self) -> "ModelConfig":
        if self.family in ("dense", "moe", "encdec"):
            assert self.n_heads > 0 and self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.experts_per_tok > 0
        if self.family == "rwkv":
            assert self.d_model % self.rwkv_head_dim == 0
        if self.family == "hybrid":
            assert self.pattern and self.rglru_dim > 0
        return self
