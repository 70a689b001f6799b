"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. One shared attn+MLP block is applied every ``attn_every``
Mamba2 layers (weights shared across invocations, fresh KV per invocation).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    attn_every=6,  # 9 shared-block invocations over 54 layers
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, attn_every=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
