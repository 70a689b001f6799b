"""Online graph-query serving launcher on the card (the JAX package's
``launch/graph_serve.py``).

Loads one graph onto the device and replays a seeded open-loop workload of
k-hop / shortest-path / personalized-PageRank / lookup queries through the
serving stack — admission queue, batched multi-source execution through
the fused loop (``ShardedDaemon``; ``--kernel cuda``, the default, runs the
CSR-tile kernel once an iteration at K = the batch's bucket), result LRU —
optionally killing a logical device mid-replay to exercise the elastic
shrink(+grow) path under live traffic:

  PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
      --num-vertices 2000 --num-edges 16000 --requests 100 --rate 200

  # elastic: 8 logical devices on the card; kill device 3 during the 3rd
  # fused iteration, recover it ten iterations later — serving continues
  # across both migrations
  PYTHONPATH=src python -m repro_torch.launch.graph_serve --mesh 8 \\
      --kill-at 3 --kill-device 3 --recover-at 13

``--device cpu`` runs the plain PyTorch path; ``--device cuda`` (the
default) raises on a machine without a GPU.  On the card it prints the
card's name and power limit beside the throughput and latencies.

Under ``torchrun`` (when ``WORLD_SIZE`` is set) the shard axis spans the
ranks: a ``RankMesh`` of one logical device a rank
(``launch.mesh.make_rank_mesh``), the session's families over it.  Every
rank replays the same workload — admission reads only the virtual clock,
so every rank forms the same batches — and rank 0 prints:

  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.graph_serve --num-shards 8     # gloo, one card
  (--backend nccl: a card a rank; --kill-device names a world device)
"""
from __future__ import annotations

import argparse
import subprocess

from repro_torch.dist.fault import FailureSchedule, FleetMonitor
from repro_torch.graph import generate
from repro_torch.kernels.ops import CSRConfig
from repro_torch.launch.mesh import make_rank_mesh, world_size
from repro_torch.plug.protocols import divisor_mesh
from repro_torch.serve import (GraphServeRouter, GraphServeSession,
                               generate_workload, replay)


def card_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    what ran instead."""
    if device == "cpu":
        return "device cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out[0] if out else "nvidia-smi printed nothing"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-vertices", type=int, default=2_000)
    ap.add_argument("--num-edges", type=int, default=16_000)
    ap.add_argument("--graph-seed", type=int, default=7)
    ap.add_argument("--num-shards", type=int, default=8)
    ap.add_argument("--mesh", type=int, default=None,
                    help="logical devices of the shard axis on the card "
                         "(must divide --num-shards; default 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernel", choices=("reference", "cuda"),
                    default="cuda")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=0.005,
                    help="admission deadline (virtual seconds)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered load, requests per virtual second")
    ap.add_argument("--workload-seed", type=int, default=0)
    ap.add_argument("--repeat-fraction", type=float, default=0.2,
                    help="fraction of requests re-issuing an earlier "
                         "query (cache-hit path)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="kill a logical device at this fused iteration of "
                         "the next run — serving migrates and continues")
    ap.add_argument("--kill-device", type=int, default=3)
    ap.add_argument("--recover-at", type=int, default=None,
                    help="bring the killed device back at this iteration "
                         "— the shard axis grows again")
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
        return _serve(args, ranks)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _serve(args, ranks) -> dict:
    say = print if ranks is None or ranks.rank == 0 else (lambda *a: None)
    mesh = args.mesh if ranks is None else ranks
    g = generate.rmat(args.num_vertices, args.num_edges,
                      seed=args.graph_seed)
    failures = None
    monitor = None
    if args.kill_at is not None:
        recov = ([(args.recover_at, args.kill_device)]
                 if args.recover_at is not None else ())
        failures = FailureSchedule(
            kills=[(args.kill_at, args.kill_device)], recoveries=recov)
        monitor = FleetMonitor(num_hosts=divisor_mesh(args.num_shards,
                                                      mesh))
    session = GraphServeSession(
        g, num_shards=args.num_shards, kernel=args.kernel,
        max_batch=args.max_batch, monitor=monitor, failures=failures,
        device=args.device if ranks is None else None, mesh=mesh,
        # pinned: an autotuned family may pick the flat merge, which runs
        # no CSR-tile kernel
        csr_config=CSRConfig())
    router = GraphServeRouter(session, max_wait=args.max_wait)

    wl = generate_workload(
        num_requests=args.requests, num_vertices=g.num_vertices,
        rate=args.rate, seed=args.workload_seed,
        repeat_fraction=args.repeat_fraction)
    answers, stats = replay(router, wl)

    where = (f"mesh={args.mesh}" if ranks is None else
             f"{ranks.world} ranks ({ranks.backend}) on {ranks.device}")
    say(f"graph |V|={g.num_vertices} |E|={g.num_edges}, "
        f"{args.num_shards} shards, {where}, "
        f"kernel={args.kernel}, device={args.device}")
    say(f"{stats['completed']} completed ({stats['cached']} cache hits) "
        f"in {stats['wall_s']:.2f}s wall — "
        f"{stats['throughput_qps']:.1f} qps, "
        f"p50 {stats['p50_ms']:.2f}ms p99 {stats['p99_ms']:.2f}ms "
        f"on {card_line(args.device)}")
    for kind, row in stats["kinds"].items():
        say(f"  {kind:8s} n={row['count']:4d} cached={row['cached']:3d} "
            f"p50={row['p50_ms']:8.2f}ms p99={row['p99_ms']:8.2f}ms "
            f"mean_batch={row['mean_batch']:.1f}")
    say(f"families built: {len(session.compiled_families)} "
        f"(init_s {', '.join(f'{v:.2f}' for v in session.init_s.values())}"
        f"), mesh epoch: {session.mesh_epoch}, "
        f"cache: {router.cache.stats.as_dict()}")
    return stats


if __name__ == "__main__":
    main()
