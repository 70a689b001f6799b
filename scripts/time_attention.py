#!/usr/bin/env python3
"""Times the port's attention kernel against SDPA on one GPU.

    PYTHONPATH=src python3 scripts/time_attention.py LABEL [--seed 0]
        [--dtype float32|bfloat16]
    python3 scripts/time_attention.py --cut VARIANT SRC_ROOT DEST_ROOT

For each case it prints, in one JSON line under LABEL: the kernel's time
(``repro_torch.kernels.flash_attention.flash_attention``, CUDA events, mean
of 30 calls after 3), the time of ``scaled_dot_product_attention`` on the
same inputs (float32 matrix products in full float32, TF32 off), and the
largest share of the tolerance that the kernel's output takes against
``flash_attention_plain``: one bf16 ulp (|Δ| ≤ 2^-7·|want| + 1e-5) in
bfloat16, the ``cuda`` tests' atol 2e-5 in float32.  The cases: in
bfloat16, qwen2-72b's layer at S=4096, causal and full, and a whisper-sized
MHA case; in float32, whisper-base's head dim (8 heads, D=64, S=4096), full
and causal, D=128 at 8:1 GQA, S=4096, causal, and zamba2-2.7b's heads (32
of D=80, S=4096, causal).  ``--dtype`` keeps the cases of one dtype.
Whichever ``repro_torch`` is first on PYTHONPATH is timed (its kernels
built into that checkout's ``build/``), so two checkouts can be compared in
one call, in turns (A, B, B, A).  Exits 2 without a GPU.

The second form copies SRC_ROOT's ``src/repro_torch`` to DEST_ROOT and
patches the float32 kernel (``csrc/flash_attention.cu`` and the split in
``csrc/tf32.cuh``, which the SSD kernel shares) into a cut-down or
altered copy, to see where its time goes (``CUTS`` below names them and
says which are wrong on purpose); each patch fails loudly on a source it
does not fit.  Time the copy with ``PYTHONPATH=DEST_ROOT/src``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

# (B, Hq, Hkv, S, D, causal, dtype)
CASES = ((1, 64, 8, 4096, 128, True, "bfloat16"),
         (1, 64, 8, 4096, 128, False, "bfloat16"),
         (4, 32, 32, 1024, 64, True, "bfloat16"),
         (1, 8, 8, 4096, 64, False, "float32"),
         (1, 8, 8, 4096, 64, True, "float32"),
         (1, 64, 8, 4096, 128, True, "float32"),
         (1, 32, 32, 4096, 80, True, "float32"))
# (rtol, atol) of |Δ| ≤ atol + rtol·|want|
TOLERANCE = {"bfloat16": (2.0 ** -7, 1e-5), "float32": (0.0, 2e-5)}

_F32 = "kernels/csrc/flash_attention.cu"
# the split and mma3, shared with the SSD kernel
_TF32 = "kernels/csrc/tf32.cuh"
_SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  small = __float_as_uint(x - __uint_as_float(big));\n")
_KEY_TILE = ("  return smem_bytes(D, 64) <= kSmemFor2   ? 64\n"
             "         : smem_bytes(D, 32) <= kSmemFor2 ? 32\n"
             "                                          : 16;\n")
# variant -> [(file under src/repro_torch, old text, new text)]; each old
# text must occur exactly once
CUTS = {
    # the split by cvt.rna.tf32.f32 for big and for small (right, not cut:
    # the rounding the integer split reproduces, as PTX spells it)
    "f32_cvt_rna": [(_TF32, _SPLIT,
                     "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(big) : "
                     "\"f\"(x));\n  big &= 0xffffe000u;\n"
                     "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(small) "
                     ": \"f\"(x - __uint_as_float(big)));\n")],
    # small rounded to nearest as well, by the same two integer instructions
    # (right: the split the CPU emulation's round_tf32 describes for both)
    "f32_round_small": [(_TF32, _SPLIT,
                         "  big = (__float_as_uint(x) + 0x1000u) & "
                         "0xffffe000u;\n  small = (__float_as_uint(x - "
                         "__uint_as_float(big)) + 0x1000u) & 0xffffe000u;\n")],
    # big truncated, one instruction (right to ~2^-20, not the rounding
    # chosen)
    "f32_trunc": [(_TF32, _SPLIT,
                   "  big = __float_as_uint(x) & 0xffffe000u;\n"
                   "  small = __float_as_uint(x - __uint_as_float(big));\n")],
    # softmax by expf (right: the FMA kernel's exp)
    "f32_expf": [(_F32, "exp2_approx(fmaf(s, kLog2e, -mlog2e[e >> 1]))",
                  "expf(s - m[e >> 1])")],
    # no P·V products (wrong on purpose: O stays 0)
    "f32_no_pv": [(_F32, "        mma3(o[j], pb, ps, bb0, bb1, bs0, bs1);\n",
                   "")],
    # two products, a_s·b_b left out (wrong on purpose: TF32 accuracy on a)
    "f32_two_products": [(_TF32, "  mma(c, as, bb0, bb1);\n", "")],
    # one key-tile size at every head dim (right)
    "f32_key_tile_64": [(_F32, _KEY_TILE, "  return 64;\n")],
    "f32_key_tile_32": [(_F32, _KEY_TILE, "  return 32;\n")],
}


def cut(variant: str, src_root: Path, dest_root: Path) -> None:
    if variant not in CUTS:
        raise SystemExit(f"unknown variant {variant!r}; known: {sorted(CUTS)}")
    pkg = dest_root / "src" / "repro_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(src_root / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in CUTS[variant]:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{variant}: {rel} holds the text to replace "
                             f"{text.count(old)} times, not once:\n{old}")
        path.write_text(text.replace(old, new))


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
    ap.add_argument("label", nargs="?")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(TOLERANCE))
    ap.add_argument("--cut", nargs=3, metavar=("VARIANT", "SRC_ROOT",
                                               "DEST_ROOT"))
    args = ap.parse_args(argv)
    if args.cut:
        variant, src, dest = args.cut
        cut(variant, Path(src), Path(dest))
        return 0
    if args.label is None:
        ap.error("LABEL is required")

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "card": smi}
    for b, hq, hkv, s, d, causal, dtype in CASES:
        if args.dtype not in (None, dtype):
            continue
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(getattr(torch, dtype))
                   for h in (hq, hkv, hkv))
        out = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        rtol, atol = TOLERANCE[dtype]
        share = (out.float() - want).abs() / (atol + rtol * want.abs())
        del want
        mask = "causal" if causal else "full"
        res[f"{dtype} B{b} Hq{hq} Hkv{hkv} S{s} D{d} {mask}"] = {
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
