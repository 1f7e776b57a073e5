"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2, as xAI published it
(github.com/xai-org/grok-1: ``run.py``'s ``LanguageModelConfig`` /
``TransformerConfig`` and ``model.py``): the input embedding times
78.38367176906169 and the logits times 0.5773502691896257, one table for
both (a tied head), RMSNorm with ε 1e-5 before and after attention and
before and after the MoE (the post-norm's output is added), attention
logits capped at 30 · tanh(s / 30) after the 1/√128 scale in prefill and
in decode, the top-2 gates the router's softmax gave (not
renormalised), every token routed to its two experts with no drop.
8 experts do not divide a 16-way model axis → TP-inside-expert sharding
(moe_shard="tp", see models/moe.py)."""
from repro_torch.configs.base import ModelConfig

PUBLISHED = dict(
    norm="rmsnorm", act="gelu", tie_embeddings=True, norm_eps=1e-5,
    post_norms=True, embed_scale=78.38367176906169,
    logit_scale=0.5773502691896257, moe_renormalize=False,
    moe_dropless=True, attn_logit_softcap=30.0,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
        vocab_size=131072, head_dim=128,
        n_experts=8, experts_per_tok=2, moe_shard="tp",
        capacity_factor=1.25, **PUBLISHED,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
        n_experts=4, experts_per_tok=2, moe_shard="tp",
        capacity_factor=1.25, **PUBLISHED,
    ).validate()
