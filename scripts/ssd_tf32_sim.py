#!/usr/bin/env python3
"""Why the SSD chunk kernel takes three TF32 products: a CPU simulation of
its numerics.

    python3 scripts/ssd_tf32_sim.py [--seed 0] [--heads 4] [--chunks 2]
                                    [--l 256] [--n 128] [--p 64]

It runs the Mamba2 SSD chunk step in float32 as ``csrc/ssd_scan.cu`` does,
with each of its three matrix products taken as 1, 2 or 3 TF32 products on
operands split as ``scripts/tf32_split_sim.py`` splits them (big rounded as
``cvt.rna.tf32.f32`` rounds, small = x − big as the tensor cores read it):

- C·Bᵀ (K = N), a = C, b = Bᵀ;
- W·x (K = L), a = W = C·Bᵀ ∘ exp(cum_t − cum_s)·[s ≤ t] ∘ dt_s, b = x;
- the state (ws ∘ B)ᵀ·x (K = L), ws = dt·exp(cum_{L−1} − cum_s), b = x.

For each split and each input set it prints one JSON line: the max |Δ| of
y and of the state against ``ssd_chunk_plain`` (float32, dense), and the
elements over the tolerance that ``chip_smoke.py`` and the ``cuda`` tests
hold the kernel to (max |Δ| ≤ 1e-4·max(1, max |want|)).  The input sets are
those of the ``cuda`` tests: dt = softplus(N(0,1)) (``softplus``; a
256-long chunk's decay underflows) and dt log-uniform in Mamba2's range
1e-3..1e-1 (``mamba2``); x = 0.5·N(0,1), B, C = 0.3·N(0,1), a =
−exp(0.3·N(0,1)), from numpy's generator at the seed.  Defaults:
mamba2-1.3b's chunk (L=256, N=128, P=64, G=1) at 4 heads and 2 chunks.
CPU only; seconds.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.kernels.ssd_scan import ssd_chunk_plain  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "tf32_split_sim", _ROOT / "scripts" / "tf32_split_sim.py")
_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_split)
matmul_tf32 = _split.matmul_tf32

RTOL = 1e-4  # max |Δ| ≤ 1e-4·max(1, max |want|)
# (C·Bᵀ, W·x, state) products: all one; the kernel's; one product left at
# one TF32 product each; two products (a_s·b_b left out) everywhere
SPLITS = ((1, 1, 1), (3, 3, 3), (1, 3, 3), (3, 1, 3), (3, 3, 1), (2, 2, 2))


def inputs(seed, b, nc, l, h, p, g, n, dt="softplus"):
    """x, dt, a, B, C (float32 tensors) as the ``cuda`` tests draw them,
    from numpy's generator."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = 0.5 * randn(b, nc, l, h, p)
    if dt == "softplus":
        dts = np.log1p(np.exp(randn(b, nc, l, h))).astype(np.float32)
    else:
        lo, hi = np.log(1e-3), np.log(1e-1)
        dts = np.exp(lo + (hi - lo) * rng.random((b, nc, l, h))).astype(
            np.float32)
    a = -np.exp(0.3 * randn(h)).astype(np.float32)
    arrs = (x, dts, a, 0.3 * randn(b, nc, l, g, n), 0.3 * randn(b, nc, l, g, n))
    return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in arrs)


def chunk_tf32(x, dt, a, b_mat, c_mat, *, cb: int = 3, wx: int = 3,
               st: int = 3):
    """The kernel's arithmetic on the CPU: y (B, NC, L, H, P) and the state
    (B, NC, H, N, P), with C·Bᵀ, W·x and the state as ``cb``, ``wx`` and
    ``st`` TF32 products."""
    bsz, nc, l, h, p = x.shape
    g = b_mat.shape[3]
    r = h // g
    # (B, NC, H, L, ·): head h reads group h // r
    xh = x.permute(0, 1, 3, 2, 4)
    bh = b_mat.repeat_interleave(r, dim=3).permute(0, 1, 3, 2, 4)
    ch = c_mat.repeat_interleave(r, dim=3).permute(0, 1, 3, 2, 4)
    dth = dt.permute(0, 1, 3, 2)
    cum = torch.cumsum(a[:, None] * dth, dim=-1)
    live = torch.ones((l, l), dtype=torch.bool).tril()
    diff = torch.where(live, cum[..., :, None] - cum[..., None, :], 0.0)
    gate = torch.where(live, torch.exp(diff), 0.0)
    w = matmul_tf32(ch, bh.transpose(-1, -2), cb) * gate * dth[..., None, :]
    y = matmul_tf32(w, xh, wx)
    ws = dth * torch.exp(cum[..., -1:] - cum)
    state = matmul_tf32((ws[..., :, None] * bh).transpose(-1, -2), xh, st)
    return y.permute(0, 1, 3, 2, 4), state


def errors(arrs, *, cb=3, wx=3, st=3) -> dict:
    """max |Δ| of y and the state against ``ssd_chunk_plain``, and the
    elements over the tolerance."""
    y, state = chunk_tf32(*arrs, cb=cb, wx=wx, st=st)
    want_y, want_state, _, _ = ssd_chunk_plain(*arrs)
    out = {}
    for name, got, want in (("y", y, want_y), ("state", state, want_state)):
        err = (got - want).abs()
        tol = RTOL * max(1.0, float(want.abs().max()))
        out[name] = {"max_abs_err": float(err.max()), "tol": tol,
                     "over_tol": int((err > tol).sum()),
                     "elements": want.numel()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--l", type=int, default=256)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--p", type=int, default=64)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for dt in ("softplus", "mamba2"):
        arrs = inputs(args.seed, 1, args.chunks, args.l, args.heads, args.p,
                      1, args.n, dt)
        for cb, wx, st in SPLITS:
            print(json.dumps({
                "dt": dt, "L": args.l, "N": args.n, "P": args.p,
                "heads": args.heads, "chunks": args.chunks,
                "products": {"cb": cb, "wx": wx, "state": st},
                **errors(arrs, cb=cb, wx=wx, st=st)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
