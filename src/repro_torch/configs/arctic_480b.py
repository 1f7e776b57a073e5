"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].
128 experts divide the model axis → expert parallelism (moe_shard="ep")."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
        vocab_size=32000, head_dim=128,
        n_experts=128, experts_per_tok=2, moe_shard="ep",
        moe_dense_residual=True, dense_residual_ff=4864,
        capacity_factor=1.25,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=512, head_dim=16,
        n_experts=8, experts_per_tok=2, moe_shard="ep",
        moe_dense_residual=True, dense_residual_ff=96,
        capacity_factor=1.25,
        norm="rmsnorm", act="silu", tie_embeddings=False,
    ).validate()
