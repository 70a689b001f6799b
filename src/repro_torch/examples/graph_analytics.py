"""Graph analytics end to end: a heterogeneous-capacity deployment, the
twin of ``examples/graph_analytics.py``.

Scenario: "distributed nodes" with unequal accelerators (every other one
has 3× the capacity of the first).  The middleware partitions by Lemma 2,
runs three algorithms, skips synchronization rounds on a clustered graph,
and measures per-node throughput for an online rebalance — the paper's
pipeline in one script.

  PYTHONPATH=src python -m repro_torch.examples.graph_analytics
  (--device cpu runs the plain path; --daemon cuda the CSR-tile kernel)

In one process the two nodes are two shards.  Under ``torchrun`` (when
``WORLD_SIZE`` is set) every rank is a node: a ``RankMesh`` over the
ranks, one shard a rank, merged by ``MeshUpperSystem``'s collectives, as
the JAX example spans whatever devices exist:

  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.examples.graph_analytics           # gloo, one card
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.examples.graph_analytics --backend nccl  # a card a rank
"""
import argparse

import numpy as np

from repro_torch import plug
from repro_torch.core import balance
from repro_torch.graph import generate
from repro_torch.graph.algorithms import label_prop, sssp_bf, wcc
from repro_torch.graph.partition import partition_contiguous
from repro_torch.launch.mesh import make_rank_mesh, world_size


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-vertices", type=int, default=20_000)
    ap.add_argument("--num-edges", type=int, default=150_000)
    ap.add_argument("--daemon", default="vectorized",
                    help="vectorized | cuda | blocked | pipelined")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="under torchrun: gloo (ranks may share a card) or "
                         "nccl (one card a rank)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    ranks = None
    owns_group = False
    if world_size() > 1:
        owns_group = not dist.is_initialized()
        ranks = make_rank_mesh(
            args.backend, device=None if args.device == "cuda"
            else args.device)
    try:
        return _run(args, ranks)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, ranks) -> dict:
    say = print if ranks is None or ranks.rank == 0 else (lambda *a: None)
    nodes = 2 if ranks is None else ranks.world
    device = args.device if ranks is None else ranks.device
    # the engine's placement: this process's device, or the rank mesh
    placement = ({"device": args.device} if ranks is None
                 else {"upper": plug.MeshUpperSystem(mesh=ranks)})

    g = generate.clustered(args.num_vertices, args.num_edges,
                           num_clusters=8, p_cross=0.04, seed=1)
    say(f"clustered graph: |V|={g.num_vertices:,} |E|={g.num_edges:,}"
        + ("" if ranks is None else f"; {ranks.world} ranks "
           f"({ranks.backend}) on {ranks.device}"))

    # --- capacity-aware partitioning (Lemma 2) -----------------------------
    capacities = np.where(np.arange(nodes) % 2 == 1, 3.0, 1.0)
    fracs = balance.lemma2_fractions(1.0 / capacities)
    parts = partition_contiguous(g, nodes, fractions=fracs)
    say(f"Lemma-2 partition: {[p.num_edges for p in parts]} edges "
        f"(fractions {np.round(fracs, 3)})")

    # --- run three algorithms through the same engine ----------------------
    out = {"correct": {}}
    for name, prog in (("sssp_bf", sssp_bf(g)),
                       ("label_prop", label_prop(g)),
                       ("wcc", wcc(g.with_reverse_edges()))):
        gg = g.with_reverse_edges() if name == "wcc" else g
        pp = (partition_contiguous(gg, nodes, fractions=fracs)
              if name == "wcc" else parts)
        eng = plug.Middleware(gg, prog, daemon=args.daemon, partitions=pp,
                              options=plug.PlugOptions(block_size="auto"),
                              **placement)
        res = eng.run()
        ref, _ = plug.run_reference(gg, prog, device=device)
        ok = bool(np.allclose(np.where(np.isfinite(res.state), res.state, 0),
                              np.where(np.isfinite(ref), ref, 0), atol=1e-4))
        out["correct"][name] = ok
        say(f"  {name:10s} iters={res.iterations:3d} correct={ok} "
            f"skipped={res.stats.rounds_skipped}/{res.stats.rounds_total}")

    # --- online straggler rebalancing (CapacityEstimator) ------------------
    est = balance.CapacityEstimator(num_nodes=nodes)
    for _ in range(5):
        for j, p in enumerate(parts):
            est.update(j, entities=p.num_edges,
                       seconds=0.05 if j % 2 else 0.10)
    out["rebalance_fractions"] = est.rebalance_fractions()
    say(f"measured rebalance fractions: "
        f"{np.round(out['rebalance_fractions'], 3)}")
    return out


if __name__ == "__main__":
    main()
