#!/usr/bin/env python3
"""How far the kernels' last bits move a training step's gradients: a CPU
emulation at zamba2-2.7b's depth, which fixes ``chip_smoke.py``'s
``TRAIN_TOL``.

    python3 scripts/train_tol_sim.py [--d-model 256 --seq 512 --seed 0]

zamba2-2.7b's published config (54 Mamba2 layers, the shared attention
block every 6, bf16 compute, float32 parameters) at a reduced width runs
one loss and backward through ``kernel="reference"`` twice: once as it is,
and once with the kernels' last-bit differences emulated on the forward
outputs — one bf16 ulp on ``--ulp-share`` of the attention outputs (the
bf16 kernel and its plain version round float32 results at most one ulp
apart) and a relative 1e-6·N(0, 1) on the SSD's y (float32 sums in another
order).  The perturbation is added as a constant, so the backward is the
plain one in both runs, as on the card, where the kernels' Functions
recompute the plain version in the backward pass.  Prints one JSON line:
the loss difference and, per gradient leaf, max |Δ| / max |want| (the
largest, the median, and the leaves above 1%), the same for ||Δ|| /
||want|| per leaf, and ||Δ|| / ||want|| over all leaves.  ``--dtype
float32`` runs the compute in float32, where a relative 1e-6·N(0, 1) stands
for the float32 kernels' differences on both outputs.  CPU only.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402


def bf16_ulp(x: torch.Tensor, share: float, gen) -> torch.Tensor:
    """``x`` (bf16) with ``share`` of its elements moved one ulp up or
    down."""
    bits = x.view(torch.int16)
    pick = torch.rand(x.shape, generator=gen) < share
    step = torch.where(torch.rand(x.shape, generator=gen) < 0.5, 1, -1)
    return torch.where(pick, bits + step.to(torch.int16), bits).view(
        torch.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ulp-share", type=float, default=0.3)
    ap.add_argument("--ssd-rel", type=float, default=1e-6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    help="the compute dtype (the config's is bfloat16)")
    args = ap.parse_args(argv)

    d = args.d_model
    cfg = get_config("zamba2-2.7b").replace(
        d_model=d, num_heads=d // 64, num_kv_heads=d // 64, d_ff=4 * d,
        vocab_size=1024, dtype=args.dtype)
    model = Model(cfg, kernel="reference", device="cpu").init(
        torch.Generator().manual_seed(args.seed))
    gen = torch.Generator().manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.seq), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    want_loss, want = loss_and_grads(model, batch)

    attend, ssd_scan = A.attend, ops.ssd_scan
    noise = torch.Generator().manual_seed(args.seed + 2)

    def noisy_attend(q, k, v, **kw):
        o = attend(q, k, v, **kw)
        moved = (bf16_ulp(o.detach(), args.ulp_share, noise)
                 if o.dtype == torch.bfloat16 else o.detach() * (
                     1 + args.ssd_rel * torch.randn(o.shape,
                                                    generator=noise)))
        return o + (moved - o.detach())

    def noisy_ssd(*a, **kw):
        y = ssd_scan(*a, **kw)
        out = y[0] if isinstance(y, tuple) else y
        rel = args.ssd_rel * torch.randn(out.shape, generator=noise)
        out = out + (out.detach() * rel).to(out.dtype)
        return (out, *y[1:]) if isinstance(y, tuple) else out

    A.attend, ops.ssd_scan = noisy_attend, noisy_ssd
    try:
        got_loss, got = loss_and_grads(model, batch)
    finally:
        A.attend, ops.ssd_scan = attend, ssd_scan
    shares = {k: float((got[k] - w).abs().max() / w.abs().max())
              for k, w in want.items() if float(w.abs().max()) > 0}
    l2 = {k: float((got[k] - w).norm() / w.norm())
          for k, w in want.items() if float(w.norm()) > 0}
    total = float(torch.sqrt(sum(((got[k] - w) ** 2).sum()
                                 for k, w in want.items()))
                  / torch.sqrt(sum((w ** 2).sum() for w in want.values())))
    ordered = sorted(shares.values())
    print(json.dumps({
        "config": {"d_model": d, "layers": cfg.num_layers,
                   "attn_every": cfg.attn_every, "seq": args.seq,
                   "dtype": cfg.dtype, "ulp_share": args.ulp_share,
                   "ssd_rel": args.ssd_rel},
        "loss": float(want_loss),
        "loss_rel_diff": abs(float(got_loss - want_loss))
        / abs(float(want_loss)),
        "leaves": len(shares), "max_share": ordered[-1],
        "median_share": ordered[len(ordered) // 2],
        "worst": sorted(shares.items(), key=lambda kv: -kv[1])[:5],
        "above_1pct": sum(s > 0.01 for s in ordered),
        "max_leaf_rel_l2": max(l2.values()),
        "median_leaf_rel_l2": sorted(l2.values())[len(l2) // 2],
        "worst_rel_l2": sorted(l2.items(), key=lambda kv: -kv[1])[:3],
        "global_rel_l2": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
