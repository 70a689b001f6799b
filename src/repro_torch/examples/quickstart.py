"""Quickstart: the GX-Plug middleware in a few lines, the twin of
``examples/quickstart.py``.

``repro_torch.plug`` composes the engine from three pluggable seams — an
accelerator *daemon*, a distributed *upper system*, and a *computation
model* — and this script runs two compositions of them on PageRank and
multi-source SSSP, checked against ``plug.run_reference``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  (--device cpu runs the plain path; --daemon cuda the CSR-tile kernel)
"""
import argparse

import numpy as np

from repro_torch import plug
from repro_torch.graph import generate
from repro_torch.graph.algorithms import pagerank, sssp_bf


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-vertices", type=int, default=10_000)
    ap.add_argument("--num-edges", type=int, default=100_000)
    ap.add_argument("--daemon", default="vectorized",
                    help="vectorized | cuda | blocked | pipelined")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # a power-law graph, like the paper's social-network datasets
    g = generate.rmat(num_vertices=args.num_vertices,
                      num_edges=args.num_edges, seed=0)
    print(f"graph: |V|={g.num_vertices:,} |E|={g.num_edges:,}")

    cells = (
        ("pagerank", pagerank, "host", "bsp"),
        ("sssp-bf(4src)", sssp_bf, "mesh", "gas"),  # dist-layer merge
    )
    out = []
    for name, make, upper, model in cells:
        prog = make(g)
        mw = plug.Middleware(
            g, prog,
            daemon=args.daemon,
            upper=upper,             # "host" NumPy merge | "mesh" device fold
            model=model,             # "bsp" | "gas" (PowerGraph ordering)
            num_shards=4,
            options=plug.PlugOptions(
                block_size="auto",   # Lemma-1 optimal edge blocks
                sync_caching=True,
                sync_skipping=True,
            ),
            device=args.device)
        res = mw.run(max_iterations=50)
        ref, _ = plug.run_reference(g, prog, max_iterations=50,
                                    device=args.device)
        ok = bool(np.allclose(np.where(np.isfinite(res.state), res.state, 0),
                              np.where(np.isfinite(ref), ref, 0), atol=1e-4))
        st = res.stats
        print(f"{name:14s} [{upper}/{model}] iters={res.iterations:3d} "
              f"wall={res.wall_time:.2f}s correct={ok} "
              f"sync-skipped={st.rounds_skipped}/{st.rounds_total} "
              f"sync-volume-saved="
              f"{1 - st.lazy_bytes / max(st.dense_bytes, 1):.0%}")
        out.append({"name": name, "iterations": res.iterations,
                    "correct": ok})
    return out


if __name__ == "__main__":
    main()
