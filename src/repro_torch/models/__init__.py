"""The model stack (dense, vlm, ssm and hybrid families) for serving."""
from repro_torch.models.model import Model

__all__ = ["Model"]
