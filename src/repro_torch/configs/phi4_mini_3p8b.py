"""phi4-mini-3.8b — dense, RoPE + SwiGLU + GQA, tied embeddings.
[arXiv:2412.08905; hf] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

Sharding note: 24 query heads do not divide the 16-wide model axis; the
divisibility fallback shards head_dim (128/16=8) instead — see
dist/sharding.py.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=96, num_heads=3, num_kv_heads=1,
        d_ff=128, vocab_size=256)
