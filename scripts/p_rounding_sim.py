#!/usr/bin/env python3
"""Why the bf16 attention kernel splits P: a CPU simulation of its
numerics.

    python3 scripts/p_rounding_sim.py [--seed 0]

For one head (q, k, v = randn rounded to bfloat16, as ``chip_smoke.py``
makes them) it runs the kernel's online softmax in float32 — q·kᵀ on the
raw bf16 values, then the scale, the mask and the running max over key
tiles of 64 or 128 — and rounds P three ways before the P·V product: to
one bf16 value (what SDPA and FlashAttention-2/3 do), to TF32, or to the
pair P_hi = bf16(p), P_lo = bf16(p − P_hi) with P·V = P_hi·V + P_lo·V (what
``csrc/flash_attention_sm90.cu`` does).  Each output, rounded to bf16, is
held against ``flash_attention_plain`` (dense float32 softmax) with the
port's one-ulp tolerance |Δ| ≤ 2^-7·|want| + 1e-5, and one JSON line per
(shape, tile, rounding) gives the elements over it and the largest share
of an element's tolerance.  CPU only; a few seconds per shape.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

RTOL, ATOL = 2.0 ** -7, 1e-5
# (S, D, causal): qwen2-72b's head at S=4096, and the cuda tests' S
SHAPES = [(4096, 128, True)] + [(s, d, c) for s in (192, 1000)
                                for d in (16, 32, 64, 128)
                                for c in (True, False)]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at 10 explicit mantissa bits."""
    bits = x.view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def p_times_v(p: torch.Tensor, v: torch.Tensor, how: str) -> torch.Tensor:
    if how == "bf16":
        return p.bfloat16().float() @ v
    if how == "tf32":
        return round_tf32(p) @ v
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    return hi @ v + lo @ v


def online_attention(q, k, v, *, causal: bool, bk: int, how: str):
    """q, k, v (S, D) float32 holding bf16 values → (S, D) bf16."""
    s, d = q.shape
    scale_log2 = (1.0 / d ** 0.5) * 1.4426950408889634
    m = torch.full((s, 1), -1e30)
    l = torch.zeros((s, 1))
    acc = torch.zeros((s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        x = (q @ kt.T) * scale_log2
        if causal:
            x = x.masked_fill(torch.arange(k0, k0 + kt.shape[0])[None, :]
                              > qpos, -1e30)
        m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
        p = torch.where(x == -1e30, 0.0, torch.exp2(x - m_new))
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(dim=1, keepdim=True)
        acc = alpha * acc + p_times_v(p, vt, how)
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, torch.get_num_threads()))
    gen = torch.Generator().manual_seed(args.seed)
    for s, d, causal in SHAPES:
        q, k, v = (torch.randn((s, d), generator=gen).bfloat16()
                   for _ in range(3))
        want = flash_attention_plain(q[None, None], k[None, None],
                                     v[None, None], causal=causal)[0, 0]
        want = want.float()
        for bk in (64, 128):
            for how in ("bf16", "tf32", "hilo"):
                got = online_attention(q.float(), k.float(), v.float(),
                                       causal=causal, bk=bk, how=how)
                share = ((got.float() - want).abs()
                         / (ATOL + RTOL * want.abs()))
                print(json.dumps({
                    "S": s, "D": d, "causal": causal, "BK": bk, "P": how,
                    "elements": want.numel(),
                    "elements_over": int((share > 1).sum()),
                    "max_share": float(share.max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
