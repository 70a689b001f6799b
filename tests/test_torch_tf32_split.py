"""The float32 attention kernel's numerics, emulated on the CPU.

``scripts/tf32_split_sim.py`` splits operands as ``csrc/flash_attention.cu``
does (big rounded as ``cvt.rna.tf32.f32`` rounds, small = x − big as the
tensor cores read it) and runs the kernel's online softmax with each matrix
product taken as 1, 2 or 3 TF32 products.  These tests pin the rounding on
chosen bit patterns, and that the kernel's split (three products for both
q·kᵀ and P·V) stays within the ``cuda`` tests' atol 2e-5 of
``flash_attention_plain``, while one plain TF32 product does not come near.
The kernel itself is held against ``flash_attention_plain`` on the card in
tests/test_torch_cuda.py.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "tf32_split_sim.py"
_spec = importlib.util.spec_from_file_location("tf32_split_sim", _PATH)
sim = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sim)

ATOL = 2e-5  # tests/test_torch_cuda.py, float32


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(x: torch.Tensor) -> int:
    return int(x.view(torch.int32).item()) & 0xFFFFFFFF


def _bits_low(x: torch.Tensor) -> int:
    return int((x.view(torch.int32) & 0x1FFF).abs().max())


# (input bits, cvt.rna.tf32.f32's result bits)
ROUNDING = [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero
    (0x3F803000, 0x3F804000),  # 1 + 3·2^-11: a tie above an odd TF32
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero, negative
    (0xC0490FDB, 0xC0490000),  # -pi: down in magnitude
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x00000FFF, 0x00000000),  # a subnormal to zero
    (0x007FFFFF, 0x00800000),  # the largest subnormal to the least normal
    (0x7F7FFFFF, 0x7F800000),  # the largest finite value: to inf
    (0x7F7FEFFF, 0x7F7FE000),  # below its tie: the largest TF32
    (0x7F800000, 0x7F800000),  # inf passes through
    (0xFF800000, 0xFF800000),  # -inf passes through
    (0x7FC00001, 0x7FC00001),  # NaN passes through, payload and all
]


@pytest.mark.parametrize("bits,want", ROUNDING,
                         ids=[f"{b:08x}" for b, _ in ROUNDING])
def test_round_tf32_bit_patterns(bits, want):
    assert _bits(sim.round_tf32(_f32(bits))) == want


def test_split_reassembles_float32():
    """The kernel's split, big + small, holds 21 mantissa bits of x:
    |x − big − small| is below 2^-21 |x| for every normal x."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * np.float32(1e3) ** rng.uniform(-1, 1, 4096
                                                          ).astype(np.float32))
    big, small = sim.split_tf32(x)
    assert torch.equal(big, sim.round_tf32(x))
    assert _bits_low(big) == 0 and _bits_low(small) == 0
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -21 * x.double().abs()).all())


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_three_products_hold_the_cuda_tolerance(causal):
    """S=200 (a ragged last tile), D=64, GQA 2:1: the kernel's split within
    atol 2e-5 of the dense float32 softmax."""
    q, k, v = _inputs(1, 1, 4, 2, 200, 64)
    got = sim.attention(q, k, v, causal=causal, qk=3, pv=3)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_one_product_is_far_coarser(causal):
    """One TF32 product per matmul errs more than ten times the split, and
    beyond atol 2e-5: why the kernel pays for three."""
    q, k, v = _inputs(1, 1, 4, 2, 200, 64)
    want = flash_attention_plain(q, k, v, causal=causal)
    err1 = float((sim.attention(q, k, v, causal=causal, qk=1, pv=1)
                  - want).abs().max())
    err3 = float((sim.attention(q, k, v, causal=causal, qk=3, pv=3)
                  - want).abs().max())
    assert err1 > ATOL
    assert err1 > 10 * err3
