"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3 family; hf].
Note q_dim = 64·128 = 8192 ≠ d_model (explicit head_dim, o_proj back)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
        vocab_size=151936, head_dim=128,
        qkv_bias=False, qk_norm=True, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab_size=512, head_dim=16,
        qkv_bias=False, qk_norm=True, rope_theta=10_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()
