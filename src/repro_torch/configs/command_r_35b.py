"""command-r-35b — dense GQA, no bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256)
