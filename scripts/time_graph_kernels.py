#!/usr/bin/env python3
"""Times the port's two graph kernels at chip_smoke.py's shard-0 shapes.

    PYTHONPATH=<checkout>/src python3 scripts/time_graph_kernels.py LABEL \
        [--scale 20] [--seed 0] [--profile]
    python3 scripts/time_graph_kernels.py --cut VARIANT SRC_ROOT DEST_ROOT

The first form builds the kernels of whichever ``repro_torch`` is first on
PYTHONPATH (into that checkout's ``build/``) and prints one JSON line under
LABEL with, for each case, the kernel's time (CUDA events, mean of 50 calls
after 5), the library yardstick (one ``scatter_reduce`` merging the same
precomputed messages), the bound (bytes over 3.35 TB/s, counted as
chip_smoke.py counts them) and whether the result matches the plain
version (min bit-equal, sum within rtol 1e-4).  Cases, on a Graph500 R-MAT
graph of 2^scale vertices and 16 edges each, 4 shards, shard 0:

* ``csr_tile`` over every CSR tile (ET 512), pagerank (sum, K=1, every
  edge live) and sssp_bf (min, K=4, a random half of the vertices active);
* ``edge_block`` over all 64 edge blocks in one launch (nb=64), and one
  launch per block as ``BlockedDaemon`` makes them (nb=1; the time is the
  mean per launch over all blocks, launched one after another), for the
  same two programs; ``device_ms`` is the same launches' time queued
  behind a sleep kernel, without the host's gaps between them.

With ``--profile`` each case also gives the device time per call of each
CUDA kernel it runs (fills, memsets, the kernel), from ``torch.profiler``.

The graph and its layouts are made once and cached under this repository's
``build/time_graph_kernels/``, so that checkouts timed one after another in
one call share them.  To compare two checkouts, run them in turns in one
call (A, B, B, A).  Exits 2 without a GPU.

The second form copies SRC_ROOT's ``src/repro_torch`` to DEST_ROOT and
patches its kernel sources into a cut-down or altered copy, to see where
the time goes (``CUTS`` below names them and says which are wrong on
purpose).  The ``csr_*`` and ``eb_no_count`` patches fit the kernel
sources as they were before the warp-cooperative redesign (commit
b938ad4), the other ``eb_*`` ones the redesigned edge block; each fails
loudly on any other source.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "time_graph_kernels"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
EDGE_FACTOR, SHARDS, EDGE_TILE = 16, 4, 512
SUM_RTOL, SUM_ATOL = 1e-4, 1e-12
PROFILE = False  # --profile: device time per CUDA kernel (torch.profiler)

_CSR = "kernels/csrc/csr_tile.cu"
_EB = "kernels/csrc/edge_block.cu"
# variant -> [(file under src/repro_torch, old text, new text)]; each old
# text must occur exactly once
CUTS = {
    # -- of the kernels before the redesign --
    # phase 2 (the run walk) never runs: the tile's rows keep the identity
    "csr_no_phase2": [(
        _CSR,
        "  for (int e = threadIdx.x; e < p.ET; e += blockDim.x) {\n"
        "    const int r = sseg[e];",
        "  for (int e = threadIdx.x; e < p.ET && p.RT < 0; e += blockDim.x) {\n"
        "    const int r = sseg[e];")],
    # the identity fill of all RT rows never runs
    "csr_no_fill": [(
        _CSR,
        "  for (int i = threadIdx.x; i < p.RT * p.K; i += blockDim.x) "
        "part[i] = p.ident;\n"
        "  for (int r = threadIdx.x; r < p.RT; r += blockDim.x) cnts[r] = 0;\n",
        "")],
    # K a template constant for K=1 and K=4 (right, not cut: the same
    # kernel with its loops and predicates resolved at compile time)
    "csr_k_fixed": [
        (_CSR,
         "template <int OP, int M>\n__global__ void "
         "__launch_bounds__(kCsrThreads) csr_tile_kernel(CsrParams p) {\n",
         "template <int OP, int M, int KF>\n__global__ void "
         "__launch_bounds__(kCsrThreads) csr_tile_kernel(CsrParams p) {\n"
         "  if (KF > 0) p.K = KF;\n"),
        (_CSR,
         "          csr_tile_kernel<OP, M>, cudaFuncAttributeMax",
         "          kern, cudaFuncAttributeMax"),
        (_CSR,
         "    csr_tile_kernel<OP, M><<<",
         "    kern<<<"),
        (_CSR,
         "    const size_t smem = csr_smem_bytes(p.ET, p.K);\n",
         "    const size_t smem = csr_smem_bytes(p.ET, p.K);\n"
         "    auto kern = p.K == 1 ? csr_tile_kernel<OP, M, 1>\n"
         "                : (p.K == 4 ? csr_tile_kernel<OP, M, 4>\n"
         "                            : csr_tile_kernel<OP, M, 0>);\n")],
    # no count atomic: K atomics per live edge instead of K + 1
    "eb_no_count": [(_EB, "  atomicAdd(p.counts + d, 1);\n", "")],
    # -- of the redesigned kernels --
    # sum without the staging rows: a scalar atomicAdd per column and one
    # for the count, straight into partial and counts (right, not cut: the
    # design the vector atomics replace, with 4 edges a thread and K fixed)
    "eb_sum_direct": [
        (_EB, "    if constexpr (M == kSum) {\n      stage_edge<KT>",
         "    if constexpr (M == kSum && false) {\n      stage_edge<KT>"),
        (_EB, "    if constexpr (M == kSum) {\n      err = cudaMemsetAsync",
         "    if constexpr (M == kSum && false) {\n      err = cudaMemsetAsync"),
        (_EB, "    if (err != cudaSuccess || M != kSum) return err;",
         "    if (err != cudaSuccess || true) return err;")],
    # edges a thread and threads a CTA (right, not cut)
    "eb_edges2": [(_EB, "constexpr int kEdges = 4;", "constexpr int kEdges = 2;")],
    "eb_edges1": [(_EB, "constexpr int kEdges = 4;", "constexpr int kEdges = 1;")],
    "eb_threads256": [(_EB, "constexpr int kBlockThreads = 128;",
                       "constexpr int kBlockThreads = 256;")],
    # min/max outputs filled by torch.full and torch.zeros in the wrapper,
    # as before the redesign, instead of the C entry's fill and memset
    "eb_torch_fill": [
        (_EB,
         "      edge_block_fill<<<grid_for((p.rows * p.K + 3) / 4), "
         "kBlockThreads, 0,\n                        p.stream>>>(p);\n"
         "      err = cudaGetLastError();\n      if (err == cudaSuccess) {",
         "      err = cudaSuccess;\n      if (false) {"),
        ("kernels/edge_block.py",
         "    partial = torch.empty((nb, vb, k), dtype=torch.float32,\n"
         "                          device=vstate.device)\n"
         "    counts = torch.empty((nb, vb), dtype=torch.int32, "
         "device=vstate.device)\n    if nb * b * vb == 0:",
         "    partial = torch.full((nb, vb, k), program.monoid.identity,\n"
         "                         dtype=torch.float32, device=vstate.device)\n"
         "    counts = torch.zeros((nb, vb), dtype=torch.int32, "
         "device=vstate.device)\n    if nb * b * vb == 0:")],
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


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    # chip_smoke.py has the same helper; importing it would put this
    # checkout's src/ ahead of the PYTHONPATH under test
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


def queued_ms(fn, reps: int = 5, sleep_cycles: int = 20_000_000):
    """Device time of ``fn``'s launches with the host's gaps taken out: the
    launches are queued behind a sleep kernel of ``sleep_cycles`` (~10 ms)
    and timed from the sleep's end.  Returns the mean over ``reps`` and
    whether the host had queued them all before the sleep ended every time
    (else the time still holds host gaps)."""
    import torch

    fn()
    total, ahead = 0.0, True
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        ahead &= not start.query()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, ahead


def shapes(scale: int, seed: int) -> dict:
    """Shard 0's edge blocks and CSR tiles and the two programs' states,
    as chip_smoke.py makes them (same generator, seed and order of draws);
    cached as numpy arrays."""
    import numpy as np

    path = CACHE / f"shapes-s{scale}-seed{seed}.npz"
    if path.exists():
        with np.load(path) as z:
            return dict(z)
    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.graph.compaction import tiles_from_blockset

    n = 1 << scale
    g = generate.rmat_stream(n, EDGE_FACTOR * n, seed=seed)
    parts = plug.HostUpperSystem().partition(g, SHARDS)
    # the layouts are host arrays: the probe's device does not matter
    probe = plug.Middleware(g, pagerank(g), daemon="cuda", partitions=parts,
                            device="cpu")
    bs = probe.blocksets[0]
    ts = tiles_from_blockset(bs, n, edge_tile=EDGE_TILE)
    pr_state, pr_aux = pagerank(g).init(g)
    rng = np.random.default_rng(seed)
    out = {f"ts_{k}": v for k, v in ts.arrays().items()}
    out.update(bs_vids=bs.vids, bs_lsrc=bs.lsrc, bs_ldst=bs.ldst,
               bs_w=bs.weights, bs_emask=bs.emask, bs_gsrc=bs.gsrc,
               pr_state=np.asarray(pr_state), pr_aux=np.asarray(pr_aux),
               sp_state=rng.uniform(0.0, 100.0, (n, 4)).astype(np.float32),
               sp_active=rng.random(n) < 0.5)
    CACHE.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)
    return out


def device_split(fn, reps: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel (and memset) that
    ``fn`` runs, from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            out[ev.key[:90]] = us / reps
    return out


def edge_bytes(emask) -> int:
    live = int(emask.sum())
    return live * 16 + (emask.numel() - live) * 4


def matches(got, want, got_c, want_c, monoid: str) -> bool:
    import torch

    if not torch.equal(got_c, want_c):
        return False
    if monoid == "sum":
        return bool(((got - want).abs()
                     <= SUM_ATOL + SUM_RTOL * want.abs()).all())
    return torch.equal(got, want)


def merge_ms(parts, monoid) -> float:
    """Time of one ``scatter_reduce`` per (msgs, seg, live, num_segments)
    part, all parts in turn (the library yardstick: the merge alone, on
    precomputed messages)."""
    import torch

    reduce = {"sum": "sum", "min": "amin", "max": "amax", "or": "amax"}
    calls = []
    for msgs, seg, live, num_segments in parts:
        out = torch.full((num_segments, msgs.shape[1]), monoid.identity,
                         dtype=torch.float32, device=msgs.device)
        calls.append((out, seg[live].long()[:, None].expand(
            -1, msgs.shape[1]), msgs[live]))

    def run_all():
        for out, idx, vals in calls:
            out.scatter_reduce(0, idx, vals, reduce=reduce[monoid.name],
                               include_self=True)

    return cuda_time_ms(run_all)


def time_csr(arr, program, state, aux, active) -> dict:
    import torch

    from repro_torch.kernels import edge_block as ebk

    dev = state.device
    svids = arr["ts_svids"].long()
    vsrc, vaux = state[svids].contiguous(), aux[svids].contiguous()
    t, et = arr["ts_lsrc"].shape
    rt, st, k, a = arr["ts_rows"].shape[1], vsrc.shape[1], vsrc.shape[2], \
        vaux.shape[2]
    rowst = state[arr["ts_rows"].long()].contiguous()
    emask = arr["ts_emask"] & active[arr["ts_gsrc"].long()]
    args = (vsrc, vaux, rowst, arr["ts_lsrc"], arr["ts_seg"], arr["ts_w"],
            emask.float())
    got, got_c = ebk.csr_tile(*args, program=program)
    want, want_c = ebk.csr_tile_plain(*args, program=program)
    ok = matches(got, want, got_c, want_c, program.monoid.name)
    live_src = torch.unique(
        (torch.arange(t, device=dev)[:, None] * st + arr["ts_lsrc"])[emask])
    nbytes = (edge_bytes(emask) + live_src.numel() * (k + a) * 4
              + t * rt * (k + 1) * 4)
    msgs = program.msg_gen(
        torch.take_along_dim(vsrc, arr["ts_lsrc"].long()[..., None], 1
                             ).reshape(-1, k), None,
        arr["ts_w"].reshape(-1, 1),
        torch.take_along_dim(vaux, arr["ts_lsrc"].long()[..., None], 1
                             ).reshape(-1, a))
    seg = arr["ts_seg"].long() + torch.arange(t, device=dev)[:, None] * rt
    return dict(
        matches_plain=ok, tiles=t, K=k, live_edges=int(emask.sum()),
        kernel_ms=cuda_time_ms(lambda: ebk.csr_tile(*args, program=program)),
        **({"device_us_by_kernel": device_split(
            lambda: ebk.csr_tile(*args, program=program))} if PROFILE
           else {}),
        library_ms=merge_ms([(msgs, seg.reshape(-1), emask.reshape(-1),
                              t * rt)], program.monoid),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def time_edge_block(arr, program, state, aux, active, per_block: bool
                    ) -> dict:
    import torch

    from repro_torch.kernels import edge_block as ebk

    dev = state.device
    vids = arr["bs_vids"].long()
    emask = arr["bs_emask"] & active[arr["bs_gsrc"].long()]
    full = (state[vids].contiguous(), aux[vids].contiguous(), arr["bs_lsrc"],
            arr["bs_ldst"], arr["bs_w"], emask.float())
    nb, b = arr["bs_lsrc"].shape
    vb, k, a = full[0].shape[1], full[0].shape[2], full[1].shape[2]
    if per_block:  # one contiguous (1, ...) slice per block, as uploaded
        calls = [tuple(x[i:i + 1].clone() for x in full) for i in range(nb)]
    else:
        calls = [full]
    ok = True
    for c in calls:
        got, got_c = ebk.edge_block(*c, program=program)
        want, want_c = ebk.edge_block_plain(*c, program=program)
        ok &= matches(got, want, got_c, want_c, program.monoid.name)

    def run_all():
        for c in calls:
            ebk.edge_block(*c, program=program)

    live_src = torch.unique(
        (torch.arange(nb, device=dev)[:, None] * vb + arr["bs_lsrc"])[emask])
    nbytes = (edge_bytes(emask) + live_src.numel() * (k + a) * 4
              + nb * vb * (k + 1) * 4)
    msgs = program.msg_gen(
        torch.take_along_dim(full[0], arr["bs_lsrc"].long()[..., None], 1
                             ).reshape(-1, k), None,
        arr["bs_w"].reshape(-1, 1),
        torch.take_along_dim(full[1], arr["bs_lsrc"].long()[..., None], 1
                             ).reshape(-1, a))
    msgs = msgs.reshape(nb, b, k)
    if per_block:
        parts = [(msgs[i], arr["bs_ldst"][i], emask[i], vb)
                 for i in range(nb)]
    else:
        seg = arr["bs_ldst"].long() + torch.arange(nb, device=dev)[:, None] * vb
        parts = [(msgs.reshape(-1, k), seg.reshape(-1), emask.reshape(-1),
                  nb * vb)]
    launches = len(calls)
    ms = cuda_time_ms(run_all, reps=20 if per_block else 50)
    device_ms, host_ahead = queued_ms(run_all)
    split = device_split(run_all) if PROFILE else None
    return dict(
        matches_plain=ok, blocks=nb, launches=launches, K=k,
        live_edges=int(emask.sum()),
        kernel_ms=ms / launches, launches_per_s=launches / ms * 1e3,
        device_ms=device_ms / launches, host_ahead=host_ahead,
        **({"device_us_by_kernel": split} if split else {}),
        library_ms=merge_ms(parts, program.monoid) / launches,
        bytes=nbytes // launches,
        bound_ms=nbytes / launches / HBM_BYTES_PER_S * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cut", nargs=3, metavar=("VARIANT", "SRC_ROOT",
                                               "DEST_ROOT"))
    ap.add_argument("--profile", action="store_true",
                    help="add each case's device time per CUDA kernel")
    args = ap.parse_args(argv)
    global PROFILE
    PROFILE = args.profile
    if args.cut:
        variant, src, dest = args.cut
        cut(variant, Path(src), Path(dest))
        return 0
    if args.label is None:
        ap.error("LABEL is required")

    import torch

    if not torch.cuda.is_available():
        print("time_graph_kernels: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch

    from repro_torch.graph.algorithms import pagerank, sssp_bf
    from repro_torch.graph.structure import Graph
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    arr = {k: torch.from_numpy(v).to(dev)
           for k, v in shapes(args.scale, args.seed).items()}
    build.library()
    # the programs need a graph only for their parameters: pagerank's
    # out-degrees are in pr_aux, sssp's sources are 0..3
    n = 1 << args.scale
    g = Graph(num_vertices=n, src=np.zeros(1, np.int32),
              dst=np.zeros(1, np.int32))
    pr, sp = pagerank(g), sssp_bf(g, sources=[0, 1, 2, 3])
    sp_aux = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    all_active = torch.ones(n, dtype=torch.bool, device=dev)
    progs = {"pagerank_sum_k1": (pr, arr["pr_state"], arr["pr_aux"],
                                 all_active),
             "sssp_min_k4": (sp, arr["sp_state"], sp_aux, arr["sp_active"])}
    res = {"label": args.label, "card": smi,
           "repro_torch": str(Path(repro_torch.__file__).parents[1]),
           "nvcc_seconds": build.build_seconds}
    for case, (prog, state, aux, active) in progs.items():
        res[f"csr_tile/{case}"] = time_csr(arr, prog, state, aux, active)
        res[f"edge_block/nb64/{case}"] = time_edge_block(
            arr, prog, state, aux, active, per_block=False)
        res[f"edge_block/nb1/{case}"] = time_edge_block(
            arr, prog, state, aux, active, per_block=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
