#!/usr/bin/env python3
"""Times the port's SSD chunk kernel and ``ops.ssd_scan`` on one GPU.

    python3 scripts/time_ssd.py LABEL [--src DIR] [--seed 0] [--reps 20]
    python3 scripts/time_ssd.py --cut VARIANT SRC_ROOT DEST_ROOT

At mamba2-1.3b's width (B=1, S=4096, H=64, P=64, G=1, N=128, chunk 256,
float32; the inputs of ``chip_smoke.py``'s ssd phase, from the seed) it
prints one JSON line under LABEL: the time of
``repro_torch.kernels.ssd_scan.ssd_chunk`` and of ``ops.ssd_scan`` (CUDA
events, mean of ``--reps`` calls after 3), the largest |Δ| of each of the
chunk step's four outputs against ``ssd_chunk_plain`` and the share of
``chip_smoke.py``'s tolerance (1e-4·max(1, max |want|)) it takes, and the
card's name and power limit as ``nvidia-smi`` gives them.  ``--src DIR``
imports ``repro_torch`` from ``DIR/src`` (its kernels built into
``DIR/build/``; by default this script's own checkout), so the parent
checkout from ``git archive`` and this one
can be timed in one call, in turns (parent, new, new, parent).  A cut
copy that is wrong on purpose shows it in ``check``; nothing is held
against a tolerance here.  Exits 2 without a GPU.

The second form copies SRC_ROOT's ``src/repro_torch`` to DEST_ROOT and
patches ``csrc/ssd_scan.cu`` (or the shared ``csrc/tf32.cuh``) into a
cut-down or altered copy, to see where the time goes; ``CUTS`` below names
them and says which are wrong on purpose.  Each patch fails loudly on a
source it does not fit.  Time the copy with ``--src DEST_ROOT``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

# mamba2-1.3b: d_inner 4096 = 64 heads of P=64, N=128, G=1, chunk 256
SSD = dict(b=1, s=4096, h=64, p=64, g=1, n=128, chunk=256)
RTOL = 1e-4  # chip_smoke.py: max |Δ| ≤ 1e-4·max(1, max |want|)

_SSD = "kernels/csrc/ssd_scan.cu"
_TF32 = "kernels/csrc/tf32.cuh"
_R = "constexpr int kHeadBlock = 16;"
_WX_LOOP = """\
      const float* xp = xt + (kk * 8 + q) * XS + g;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split(xp[j * 8], bb0, bs0);
        split(xp[4 * XS + j * 8], bb1, bs1);
        mma3(yacc[j], ab, as, bb0, bb1, bs0, bs1);
      }
"""
_WX_BY_PRODUCT = """\
      const float* xp = xt + (kk * 8 + q) * XS + g;
      uint32_t xbig[PJ][2], xsmall[PJ][2];
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        split(xp[j * 8], xbig[j][0], xsmall[j][0]);
        split(xp[4 * XS + j * 8], xbig[j][1], xsmall[j][1]);
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        gxtf32::mma(yacc[j], as, xbig[j][0], xbig[j][1]);
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        gxtf32::mma(yacc[j], ab, xsmall[j][0], xsmall[j][1]);
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        gxtf32::mma(yacc[j], ab, xbig[j][0], xbig[j][1]);
"""
# variant -> [(file under src/repro_torch, old text, new text)]; each old
# text must occur exactly once
CUTS = {
    # heads per C·Bᵀ panel (right: R is a choice; 1 is no sharing)
    "ssd_r1": [(_SSD, _R, "constexpr int kHeadBlock = 1;")],
    "ssd_r4": [(_SSD, _R, "constexpr int kHeadBlock = 4;")],
    "ssd_r8": [(_SSD, _R, "constexpr int kHeadBlock = 8;")],
    "ssd_r32": [(_SSD, _R, "constexpr int kHeadBlock = 32;")],
    # no state CTAs' work (wrong on purpose: state, gate, decay unwritten)
    "ssd_no_state": [(_SSD, "    state_cta<P>(p, smem, i - p.y_ctas);\n",
                      "")],
    # no y CTAs' work (wrong on purpose: y unwritten)
    "ssd_no_y": [(_SSD, "    y_cta<P>(p, smem, i);\n", "")],
    # W·x left out of the y CTAs, the C·Bᵀ panel kept (wrong on purpose)
    "ssd_no_wx": [(_SSD, "        mma3(yacc[j], ab, as, bb0, bb1, bs0, "
                         "bs1);\n", "")],
    # two TF32 products, a_s·b_b left out (wrong on purpose: TF32 accuracy
    # on a)
    "ssd_two_products": [(_TF32, "  mma(c, as, bb0, bb1);\n", "")],
    # one TF32 product, a_b·b_b alone (wrong on purpose: what the two
    # extra products cost)
    "ssd_one_product": [(_TF32, "  mma(c, as, bb0, bb1);\n  mma(c, ab, bs0, "
                                "bs1);\n", "")],
    # W·x's three products issued product by product over the n-blocks,
    # not as one dependent chain per block (right)
    "ssd_wx_by_product": [(_SSD, _WX_LOOP, _WX_BY_PRODUCT)],
    # the gate by expf (right: the FMA kernel's exp)
    "ssd_expf": [(_SSD, "cb * exp2_approx(diff * kLog2e) * dts[s]",
                  "cb * expf(diff) * dts[s]")],
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
# checkout's src/ ahead of the checkout under test.
def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
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


def inputs(seed: int):
    """x, dt, a, B, C as ``chip_smoke.ssd_inputs`` makes them (the inputs
    of tests/test_kernels.py: dt = softplus(N(0,1)))."""
    import torch

    dev = torch.device("cuda")
    b, s, h, p, g, n = (SSD[k] for k in ("b", "s", "h", "p", "g", "n"))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = 0.5 * randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    a = -torch.exp(0.3 * randn(h))
    return x, dt, a, 0.3 * randn(b, s, g, n), 0.3 * randn(b, s, g, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?")
    ap.add_argument("--src", type=Path,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cut", nargs=3, metavar=("VARIANT", "SRC_ROOT",
                                               "DEST_ROOT"))
    args = ap.parse_args(argv)
    if args.cut:
        variant, src, dest = args.cut
        cut(variant, Path(src), Path(dest))
        return 0
    if args.label is None:
        ap.error("LABEL is required")
    src = (args.src or Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(src / "src"))

    import torch

    if not torch.cuda.is_available():
        print("time_ssd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    b, s, h, p, g, n, chunk = (SSD[k] for k in ("b", "s", "h", "p", "g", "n",
                                                "chunk"))
    nc = s // chunk
    x, dt, a, bm, cm = inputs(args.seed)
    chunk_args = (x.reshape(b, nc, chunk, h, p), dt.reshape(b, nc, chunk, h),
                  a, bm.reshape(b, nc, chunk, g, n),
                  cm.reshape(b, nc, chunk, g, n))
    got = ssd.ssd_chunk(*chunk_args)
    want = ssd.ssd_chunk_plain(*chunk_args)
    torch.cuda.synchronize()
    check = {}
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        err = float((gt - wt).abs().max())
        tol = RTOL * max(1.0, float(wt.abs().max()))
        check[name] = {"max_abs_err": err, "tol_share": err / tol,
                       "finite": bool(gt.isfinite().all())}
    del got, want
    kernel_ms = cuda_time_ms(lambda: ssd.ssd_chunk(*chunk_args), args.reps)
    entry_ms = cuda_time_ms(lambda: ops.ssd_scan(x, dt, a, bm, cm,
                                                 chunk=chunk), args.reps)
    tri = chunk * (chunk + 1) // 2
    flops = (b * nc * g * 2 * n * tri
             + b * nc * h * (2 * p * tri + 2 * chunk * n * p))
    print(json.dumps({
        "label": args.label, "src": str(src),
        "module": str(Path(ssd.__file__).resolve()),
        "case": "mamba2-1.3b/f32", **SSD, "kernel_ms": kernel_ms,
        "entry_ms": entry_ms, "flops": flops,
        "tf32_share": 3 * flops / 495e12 * 1e3 / kernel_ms,
        "check": check, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
