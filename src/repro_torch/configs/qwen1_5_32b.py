"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5 family; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
        vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=512, head_dim=16,
        qkv_bias=True, rope_theta=10_000.0,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()
