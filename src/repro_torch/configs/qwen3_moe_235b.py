"""qwen3-moe-235b-a22b — MoE, 128 experts top-8, GQA kv=4, head_dim=128.
[hf:Qwen/Qwen3-30B-A3B family scaled per assignment; hf]
94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936.

Simplification noted in DESIGN.md: qk-norm omitted. Experts are sharded on
the model axis (EP=16 → 8 experts/device); token dispatch is the
gather-based sort/capacity pipeline in models/moe.py.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, moe_d_ff=64, vocab_size=256, num_experts=4,
        experts_per_token=2)
