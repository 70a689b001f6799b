"""Architecture registry: ``--arch <id>`` resolves here.

Each assigned architecture has its own module with the exact published
config (``CONFIG``) and a reduced same-family smoke config (``reduced()``),
copied as data from the JAX package's ``configs/``.
"""
from __future__ import annotations

from repro_torch.models.common import ModelConfig

from repro_torch.configs import (  # noqa: F401
    mamba2_1p3b,
    command_r_35b,
    stablelm_1p6b,
    qwen2_72b,
    phi4_mini_3p8b,
    pixtral_12b,
    zamba2_2p7b,
    whisper_base,
    qwen3_moe_235b,
    llama4_scout,
)
from repro_torch.configs.shapes import SHAPES, Shape  # noqa: F401

_MODULES = {
    "mamba2-1.3b": mamba2_1p3b,
    "command-r-35b": command_r_35b,
    "stablelm-1.6b": stablelm_1p6b,
    "qwen2-72b": qwen2_72b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "pixtral-12b": pixtral_12b,
    "zamba2-2.7b": zamba2_2p7b,
    "whisper-base": whisper_base,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "llama4-scout-17b-a16e": llama4_scout,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _MODULES[name].reduced()


def all_configs() -> dict[str, ModelConfig]:
    return {n: m.CONFIG for n, m in _MODULES.items()}


def shape_cells(name: str) -> list[str]:
    """Which of the 4 shapes this arch runs (long_500k only sub-quadratic)."""
    cfg = get_config(name)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        cells.append("long_500k")
    return cells
