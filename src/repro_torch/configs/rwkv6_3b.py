"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — data-dependent decay [arXiv:2404.05892; hf].
O(1) decode state → runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="rwkv",
        n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64, rwkv_lora_rank=64,
        norm="rmsnorm", act="silu", tie_embeddings=False,
        subquadratic=True,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-reduced", family="rwkv",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=128,
        vocab_size=512,
        rwkv_head_dim=16, rwkv_lora_rank=8,
        norm="rmsnorm", act="silu", tie_embeddings=False,
        subquadratic=True,
    ).validate()
