"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1; unverified].
8 experts do not divide a 16-way model axis → TP-inside-expert sharding
(moe_shard="tp", see models/moe.py)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
        vocab_size=131072, head_dim=128,
        n_experts=8, experts_per_tok=2, moe_shard="tp",
        capacity_factor=1.25,
        norm="rmsnorm", act="gelu", tie_embeddings=False,
        attn_logit_softcap=30.0,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
        n_experts=4, experts_per_tok=2, moe_shard="tp",
        capacity_factor=1.25,
        norm="rmsnorm", act="gelu", tie_embeddings=False,
        attn_logit_softcap=30.0,
    ).validate()
