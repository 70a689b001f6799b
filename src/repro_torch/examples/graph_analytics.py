"""Graph analytics end to end: a heterogeneous-capacity deployment, the
twin of ``examples/graph_analytics.py``.

Scenario: two "distributed nodes" with unequal accelerators (1× vs 3×).
The middleware partitions by Lemma 2, runs three algorithms, skips
synchronization rounds on a clustered graph, and measures per-node
throughput for an online rebalance — the paper's pipeline in one script.

  PYTHONPATH=src python -m repro_torch.examples.graph_analytics
  (--device cpu runs the plain path; --daemon cuda the CSR-tile kernel)
"""
import argparse

import numpy as np

from repro_torch import plug
from repro_torch.core import balance
from repro_torch.graph import generate
from repro_torch.graph.algorithms import label_prop, sssp_bf, wcc
from repro_torch.graph.partition import partition_contiguous


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-vertices", type=int, default=20_000)
    ap.add_argument("--num-edges", type=int, default=150_000)
    ap.add_argument("--daemon", default="vectorized",
                    help="vectorized | cuda | blocked | pipelined")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = generate.clustered(args.num_vertices, args.num_edges,
                           num_clusters=8, p_cross=0.04, seed=1)
    print(f"clustered graph: |V|={g.num_vertices:,} |E|={g.num_edges:,}")

    # --- capacity-aware partitioning (Lemma 2) -----------------------------
    capacities = np.array([1.0, 3.0])  # node 1 has 3× the accelerators
    fracs = balance.lemma2_fractions(1.0 / capacities)
    parts = partition_contiguous(g, 2, fractions=fracs)
    print(f"Lemma-2 partition: {[p.num_edges for p in parts]} edges "
          f"(fractions {np.round(fracs, 3)})")

    # --- run three algorithms through the same engine ----------------------
    out = {"correct": {}}
    for name, prog in (("sssp_bf", sssp_bf(g)),
                       ("label_prop", label_prop(g)),
                       ("wcc", wcc(g.with_reverse_edges()))):
        gg = g.with_reverse_edges() if name == "wcc" else g
        pp = (partition_contiguous(gg, 2, fractions=fracs)
              if name == "wcc" else parts)
        eng = plug.Middleware(gg, prog, daemon=args.daemon, partitions=pp,
                              options=plug.PlugOptions(block_size="auto"),
                              device=args.device)
        res = eng.run()
        ref, _ = plug.run_reference(gg, prog, device=args.device)
        ok = bool(np.allclose(np.where(np.isfinite(res.state), res.state, 0),
                              np.where(np.isfinite(ref), ref, 0), atol=1e-4))
        out["correct"][name] = ok
        print(f"  {name:10s} iters={res.iterations:3d} correct={ok} "
              f"skipped={res.stats.rounds_skipped}/{res.stats.rounds_total}")

    # --- online straggler rebalancing (CapacityEstimator) ------------------
    est = balance.CapacityEstimator(num_nodes=2)
    for _ in range(5):
        est.update(0, entities=parts[0].num_edges, seconds=0.10)
        est.update(1, entities=parts[1].num_edges, seconds=0.05)
    out["rebalance_fractions"] = est.rebalance_fractions()
    print(f"measured rebalance fractions: "
          f"{np.round(out['rebalance_fractions'], 3)}")
    return out


if __name__ == "__main__":
    main()
