"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Vision frontend STUB: input_specs supplies precomputed patch embeddings +
(t, h, w) M-RoPE position streams (models/frontends.py)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
        vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        mrope=True, mrope_sections=(16, 24, 24),
        norm="rmsnorm", act="silu", tie_embeddings=True,
        frontend="vision",
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
        qkv_bias=True, rope_theta=10_000.0,
        mrope=True, mrope_sections=(2, 3, 3),
        norm="rmsnorm", act="silu", tie_embeddings=True,
        frontend="vision",
    ).validate()
