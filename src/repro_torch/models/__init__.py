"""The model stack (every family: dense, vlm, moe, ssm, hybrid, encdec)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
