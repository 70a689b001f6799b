"""whisper-base — encoder-decoder; conv audio frontend STUB.
[arXiv:2212.04356; unverified] 6L d_model=512 8H d_ff=2048 vocab=51865.

``input_specs`` provides precomputed frame embeddings (B, 1500, 512) — the
conv1d×2 + log-mel frontend is stubbed per the assignment; the transformer
backbone (enc self-attn, dec self+cross attn) is fully implemented. GELU
MLPs per the paper. Decode shapes use the decoder; there is no encoder-only
decode step.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,           # decoder layers
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    activation="gelu",
    tie_embeddings=True,
    encoder_seq=1500,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, encoder_seq=16)
