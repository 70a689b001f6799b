"""stablelm-1.6b — dense, GQA kv=32 (i.e. MHA), QKV bias.
[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.
Simplification noted in DESIGN.md: full RoPE instead of 25%-partial rotary.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256)
