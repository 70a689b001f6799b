#!/usr/bin/env python3
"""Times the port's attention kernel against SDPA on one GPU.

    PYTHONPATH=src python3 scripts/time_attention.py LABEL [--seed 0]

For each case (qwen2-72b's layer at S=4096, causal and full, and a
whisper-sized MHA case) it prints, in one JSON line under LABEL: the
kernel's time (``repro_torch.kernels.flash_attention.flash_attention``, CUDA
events, mean of 30 calls after 3), the time of
``scaled_dot_product_attention`` on the same inputs, and the largest share
of the one-bf16-ulp tolerance (|Δ| ≤ 2^-7·|want| + 1e-5) that the kernel's
output takes against ``flash_attention_plain``.  Whichever ``repro_torch``
is first on PYTHONPATH is timed, so two checkouts can be compared in one
call, in turns (A, B, B, A).  Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (B, Hq, Hkv, S, D, causal)
CASES = ((1, 64, 8, 4096, 128, True), (1, 64, 8, 4096, 128, False),
         (4, 32, 32, 1024, 64, True))
RTOL, ATOL = 2.0 ** -7, 1e-5


# chip_smoke.py has the same helper; importing it would put this
# checkout's src/ ahead of the PYTHONPATH under test.
def cuda_time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "card": smi}
    for b, hq, hkv, s, d, causal in CASES:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for h in (hq, hkv, hkv))
        out = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        share = (out.float() - want).abs() / (ATOL + RTOL * want.abs())
        del want
        mask = "causal" if causal else "full"
        res[f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {mask}"] = {
            "tol_share": float(share.max()),
            "elements_over": int((share > 1).sum()),
            "kernel_ms": cuda_time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal)),
            "sdpa_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)),
        }
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
