"""The dry run's dot FLOPs against the JAX package's for every
architecture's prefill and decode step at its reduced config (B=2, S=128):
within 1% of ``hlo_analysis.analyze`` of the JAX step jitted on one CPU
device, and ``kernel="cuda"`` (launches planned at their plain versions'
dots) equal to ``kernel="reference"`` exactly.  The train cells, and the
oracle, are in ``test_torch_dryrun.py``."""
import pytest

from repro_torch.configs import ARCH_NAMES
from test_torch_dryrun import check_cell


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_dot_flops_within_one_percent_of_jax(arch, kind):
    check_cell(arch, kind)
