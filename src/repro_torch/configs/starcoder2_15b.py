"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].  LayerNorm + GELU with
biases per the published config."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
        vocab_size=49152, head_dim=128,
        qkv_bias=True, rope_theta=100_000.0,
        norm="layernorm", act="gelu", tie_embeddings=False,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
        qkv_bias=True, rope_theta=10_000.0,
        norm="layernorm", act="gelu", tie_embeddings=False,
    ).validate()
