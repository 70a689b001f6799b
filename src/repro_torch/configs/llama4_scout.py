"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

Each MoE layer = 1 routed expert (top-1 of 16) + 1 always-on shared expert
(Llama-4 style). Early-fusion multimodality is out of scope for the LM
shapes (text-only inputs per the assignment); noted in DESIGN.md.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=1,
    capacity_factor=1.25,
    shared_expert=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=256, num_experts=4,
        experts_per_token=1)
