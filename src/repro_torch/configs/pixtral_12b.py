"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.

The ViT is stubbed per the assignment: ``input_specs`` provides precomputed
patch embeddings (B, num_patches, D) which a learned projection fuses into
the token stream (early fusion).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    num_patches=1024,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_patches=8)
