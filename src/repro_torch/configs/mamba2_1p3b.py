"""mamba2-1.3b — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified] 48L d_model=2048 vocab=50280 ssm_state=128.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,        # = d_inner / ssm_head_dim (SSD heads; no attention)
    num_kv_heads=64,
    d_ff=0,              # attention-free, no MLP block (Mamba2 backbone)
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
