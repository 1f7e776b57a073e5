"""whisper-base [audio] — 6L(enc)+6L(dec) d_model=512 8H (kv=8) d_ff=2048
vocab=51865 — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].
Frontend stub: input_specs supplies precomputed (B, 1500, 512) frame
embeddings.  Decoder positions are sinusoidal here (the real model uses a
448-position learned table; the assigned decode_32k shape exceeds it —
honoured mechanically, noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        n_layers=6, n_encoder_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab_size=51865, head_dim=64,
        encoder_seq=1500, max_target_positions=448,
        norm="layernorm", act="gelu", tie_embeddings=True,
        frontend="audio",
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-reduced", family="encdec",
        n_layers=2, n_encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, head_dim=16,
        encoder_seq=32, max_target_positions=64,
        norm="layernorm", act="gelu", tie_embeddings=True,
        frontend="audio",
    ).validate()
