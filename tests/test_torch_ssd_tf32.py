"""The SSD chunk kernel's numerics, emulated on the CPU.

``scripts/ssd_tf32_sim.py`` runs the chunk step as ``csrc/ssd_scan.cu``
does, with each of its three matrix products (C·Bᵀ, W·x and the state) taken
as 1, 2 or 3 TF32 products on operands split as the kernel splits them.
These tests pin that the kernel's choice, three products on all three,
stays within the tolerance of the ``cuda`` tests and ``chip_smoke.py``
(max |Δ| ≤ 1e-4·max(1, max |want|)) of ``ssd_chunk_plain`` under both input
sets, and that one plain TF32 product does not, on any one of the three.
The kernel itself is held against ``ssd_chunk_plain`` on the card in
tests/test_torch_cuda.py.
"""
import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "ssd_tf32_sim.py"
_spec = importlib.util.spec_from_file_location("ssd_tf32_sim", _PATH)
sim = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sim)

# (L, N, H, P): a chunk that is not whole 64-row tiles, and mamba2-1.3b's
# chunk at two heads
SHAPES = [(96, 16, 4, 32), (256, 128, 2, 64)]
DTS = ["softplus", "mamba2"]


def _arrs(l, n, h, p, dt):
    return sim.inputs(l + n, 1, 2, l, h, p, 1, n, dt)


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("l,n,h,p", SHAPES,
                         ids=[f"L{s[0]}-N{s[1]}" for s in SHAPES])
def test_three_products_hold_the_tolerance(l, n, h, p, dt):
    errs = sim.errors(_arrs(l, n, h, p, dt), cb=3, wx=3, st=3)
    for name, e in errs.items():
        assert e["over_tol"] == 0, (name, e)
        assert e["max_abs_err"] < 0.1 * e["tol"], (name, e)


# Where one TF32 product on all three breaks the tolerance.  At L=96, N=16
# under Mamba2's dt it stays within it (8.2e-5 of 1e-4), still over a
# hundred times the split's error (test_one_product_is_far_coarser).
ONE_PRODUCT_BREAKS = [(256, 128, 2, 64, "softplus"),
                      (256, 128, 2, 64, "mamba2"),
                      (96, 16, 4, 32, "softplus")]


@pytest.mark.parametrize("l,n,h,p,dt", ONE_PRODUCT_BREAKS,
                         ids=[f"L{c[0]}-N{c[1]}-{c[4]}"
                              for c in ONE_PRODUCT_BREAKS])
def test_one_product_breaks_the_tolerance(l, n, h, p, dt):
    errs = sim.errors(_arrs(l, n, h, p, dt), cb=1, wx=1, st=1)
    assert errs["y"]["over_tol"] > 0, errs["y"]


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("l,n,h,p", SHAPES,
                         ids=[f"L{s[0]}-N{s[1]}" for s in SHAPES])
def test_one_product_is_far_coarser(l, n, h, p, dt):
    arrs = _arrs(l, n, h, p, dt)
    one = sim.errors(arrs, cb=1, wx=1, st=1)
    three = sim.errors(arrs, cb=3, wx=3, st=3)
    for name in ("y", "state"):
        assert one[name]["max_abs_err"] > 100 * three[name]["max_abs_err"], (
            name, one[name], three[name])


# Each product at one TF32 product, the other two split: each alone breaks
# the tolerance at mamba2-1.3b's chunk (softplus dt), so none may go.
@pytest.mark.parametrize("cb,wx,st,out", [(1, 3, 3, "y"), (3, 1, 3, "y"),
                                          (3, 3, 1, "state")],
                         ids=["c_bt", "w_x", "state"])
def test_each_product_needs_the_split(cb, wx, st, out):
    errs = sim.errors(_arrs(256, 128, 2, 64, "softplus"), cb=cb, wx=wx,
                      st=st)
    assert errs[out]["over_tol"] > 0, errs[out]
