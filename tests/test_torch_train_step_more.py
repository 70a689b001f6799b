"""One training step of the port against the JAX package's, for the
architectures with SSM, MoE and encoder-decoder layers at ``reduced()`` in
float32 — the same checks and tolerances as
``tests/test_torch_train_step.py`` (which holds the helper)."""
import pytest

from test_torch_train_step import check_arch

ARCHS = ["mamba2-1.3b", "zamba2-2.7b", "qwen3-moe-235b-a22b",
         "llama4-scout-17b-a16e", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    check_arch(arch, {})
