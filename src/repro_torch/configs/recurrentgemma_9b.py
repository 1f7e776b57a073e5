"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
— RG-LRU + local attn, pattern (R,R,A) [arXiv:2402.19427; unverified].
38 = 12×(R,R,A) + (R,R) remainder; bounded window + O(1) recurrent state →
runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
        vocab_size=256000, head_dim=256,
        pattern=("R", "R", "A"), window=2048,
        rglru_dim=4096, conv_width=4,
        rope_theta=10_000.0,
        norm="rmsnorm", act="gelu", tie_embeddings=True,
        subquadratic=True,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512, head_dim=16,
        pattern=("R", "R", "A"), window=16,
        rglru_dim=64, conv_width=4,
        rope_theta=10_000.0,
        norm="rmsnorm", act="gelu", tie_embeddings=True,
        subquadratic=True,
    ).validate()
