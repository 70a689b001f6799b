#!/usr/bin/env python3
"""Why the float32 attention kernel takes three TF32 products: a CPU
simulation of its numerics.

    python3 scripts/tf32_split_sim.py [--seed 0] [--heads 8] [--s 4096]
                                      [--d 64] [--causal]

It runs ``csrc/flash_attention.cu``'s online softmax over its key tiles in
float32, with every operand of the two matrix products split as the kernel
splits it, ``x = x_b + x_s``: ``x_b`` is x rounded to TF32 as
``cvt.rna.tf32.f32`` rounds it (nearest, ties away from zero, on the bit
pattern), and ``x_s = x − x_b`` with its low 13 bits dropped, as the tensor
cores read a TF32 operand.  Each product is taken as 1, 2 or 3 TF32
products:

- 1: ``a_b·b_b`` (one plain TF32 product);
- 2: ``a_b·b_s + a_b·b_b`` (a rounded once, b split);
- 3: ``a_s·b_b + a_b·b_s + a_b·b_b`` (both split; what the kernel does).

For q·kᵀ, a is q·scale and b is k; for P·V, a is P and b is V.  The inputs
are randn from the seed at ``chip_smoke.py``'s float32 case by default (8
heads, S=4096, D=64, full).  For each (q·kᵀ, P·V) split it prints one JSON line: the max
|Δ| against ``flash_attention_plain`` (dense float32 softmax), and the
elements over ``chip_smoke.py``'s check (max |Δ| ≤ 1e-4·max(1, max |want|))
and over the ``cuda`` tests' atol 2e-5.  CPU only; about a minute at the
defaults.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

NEG_INF = -1e30         # the kernel's logit sentinel
SMOKE_RTOL = 1e-4       # chip_smoke.py: max |Δ| ≤ 1e-4·max(1, max |want|)
TEST_ATOL = 2e-5        # tests/test_torch_cuda.py, float32
# (q·kᵀ products, P·V products)
SPLITS = ((1, 1), (3, 1), (3, 2), (3, 3))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits: add 0x1000 and clear the low 13
    bits (nearest, ties away from zero; a carry out of the mantissa moves
    the exponent, so the largest finite values go to inf).  inf and NaN
    pass through."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(finite, rounded, bits).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from float32 bits: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The kernel's split, x = big + small: big rounded as cvt.rna rounds,
    small = x − big (exact in float32) as the tensor cores read it."""
    big = round_tf32(x)
    return big, trunc_tf32(x - big)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, products: int):
    """a @ b in float32 from TF32 operands, as 1, 2 or 3 products (small
    terms first, as the kernel accumulates them)."""
    ab, a_s = split_tf32(a)
    bb, bs = split_tf32(b)
    if products == 1:
        return ab @ bb
    if products == 2:
        return ab @ bs + ab @ bb
    return (a_s @ bb + ab @ bs) + ab @ bb


def key_tile(d: int) -> int:
    """The kernel's keys per tile at head dim d (``key_tile`` in
    ``csrc/flash_attention.cu``, at d rounded up to 16)."""
    return 64 if d <= 64 else (32 if d <= 96 else 16)


def online_head(q, k, v, *, causal: bool, scale: float, qk: int, pv: int):
    """One head, q (S, D) and k, v (S, D) float32, through the kernel's
    online softmax over its key tiles → (S, D)."""
    s, d = q.shape
    bk = key_tile(d)
    qs = q * scale
    m = torch.full((s, 1), NEG_INF)
    l = torch.zeros((s, 1))
    acc = torch.zeros((s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        x = matmul_tf32(qs, kt.T, qk)
        if causal:
            # the kernel skips tiles wholly above a query tile's diagonal;
            # masking them instead adds p = 0 and leaves m where it was
            kpos = torch.arange(k0, k0 + kt.shape[0])[None, :]
            x = x.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
        p = torch.where(x == NEG_INF, 0.0, torch.exp(x - m_new))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=1, keepdim=True)
        acc = alpha * acc + matmul_tf32(p, vt, pv)
        m = m_new
    return acc / l.clamp_min(1e-30)


def attention(q, k, v, *, causal: bool, qk: int = 3, pv: int = 3):
    """q (B, Hq, S, D), k, v (B, Hkv, S, D) float32, GQA by index, scale
    1/sqrt(D) → (B, Hq, S, D): the kernel's arithmetic, head by head."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    out = torch.empty_like(q)
    for i in range(b):
        for h in range(hq):
            out[i, h] = online_head(q[i, h], k[i, h // group],
                                    v[i, h // group], causal=causal,
                                    scale=1.0 / d ** 0.5, qk=qk, pv=pv)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--causal", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, torch.get_num_threads()))
    gen = torch.Generator().manual_seed(args.seed)
    q, k, v = (torch.randn((1, args.heads, args.s, args.d), generator=gen)
               for _ in range(3))
    want = flash_attention_plain(q, k, v, causal=args.causal)
    smoke_atol = SMOKE_RTOL * max(1.0, float(want.abs().max()))
    for qk, pv in SPLITS:
        err = (attention(q, k, v, causal=args.causal, qk=qk, pv=pv)
               - want).abs()
        print(json.dumps({
            "S": args.s, "D": args.d, "heads": args.heads,
            "causal": args.causal, "qk_products": qk, "pv_products": pv,
            "max_abs_err": float(err.max()),
            "max_abs_err_per_head": [float(e) for e in
                                     err.amax(dim=(0, 2, 3))],
            "want_abs_max": float(want.abs().max()),
            "elements": want.numel(),
            "over_chip_smoke": int((err > smoke_atol).sum()),
            "chip_smoke_atol": smoke_atol,
            "over_test_atol": int((err > TEST_ATOL).sum()),
            "test_atol": TEST_ATOL}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
