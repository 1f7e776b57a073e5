"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
        vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=True,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
        qkv_bias=True, rope_theta=10_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=True,
    ).validate()
