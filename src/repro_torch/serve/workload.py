"""Seeded open-loop workloads and their deterministic replay (the JAX
package's ``serve/workload.py``; no device code).

Used by the ``launch.graph_serve`` launcher and ``chip_smoke.py``: a
workload is a list of ``(arrival_time, Query)`` pairs drawn from one
``numpy`` Generator — Poisson arrivals at the offered load, query kinds
and seed vertices from the same stream, and an optional hot set so a
fraction of requests repeat earlier queries (the cache-hit path).

Replay drives the router exactly as a server loop would, but time is the
router's :class:`~repro_torch.serve.queue.VirtualClock`: the clock
advances to each arrival, due batches are pumped, the query is
submitted.  Every admission/batching decision is a pure function of the
workload seed — two replays of the same workload produce identical batch
compositions (test-enforced) — while the SERVICE component of each
latency is the measured wall time of the fused run the query rode in.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.queue import Query
from repro_torch.serve.session import BATCH_KINDS

DEFAULT_KINDS = BATCH_KINDS + ("lookup",)


def generate_workload(*, num_requests: int, num_vertices: int, rate: float,
                      seed: int, kinds=DEFAULT_KINDS, hops: int = 2,
                      max_seeds: int = 3, repeat_fraction: float = 0.0):
    """Draws ``num_requests`` (arrival_time, Query) pairs.

    ``rate`` is the offered load in requests per (virtual) second;
    inter-arrivals are exponential.  ``repeat_fraction`` of requests
    (after the first few) re-issue an earlier query verbatim — the
    result-cache hit path.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[tuple[float, Query]] = []
    issued: list[Query] = []
    for _ in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        if issued and float(rng.random()) < repeat_fraction:
            q = issued[int(rng.integers(len(issued)))]
        else:
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "khop":
                q = Query.make("khop", int(rng.integers(num_vertices)),
                               hops=hops)
            elif kind == "lookup":
                q = Query.make(
                    "lookup",
                    rng.integers(num_vertices,
                                 size=int(rng.integers(1, max_seeds + 1))),
                    field="pagerank")
            else:  # sssp / ppr: single- or multi-seed
                q = Query.make(
                    kind,
                    rng.integers(num_vertices,
                                 size=int(rng.integers(1, max_seeds + 1))))
            issued.append(q)
        out.append((t, q))
    return out


def replay(router, workload):
    """Replays a workload through a router; returns ``(answers, stats)``.

    ``answers`` is every completed :class:`~repro_torch.serve.router.Answer`
    in completion order; ``stats`` summarizes latency percentiles per
    kind, cache behaviour, and throughput (completed requests over the
    wall time of the whole replay — the number a load test would see).
    """
    import time

    answers = []
    base = router.clock.now()  # arrivals are relative: replays compose
    t_wall = time.perf_counter()
    for arrival, query in workload:
        dt = base + arrival - router.clock.now()
        if dt > 0:
            router.clock.advance(dt)
        router.pump()
        _, hit = router.submit(query)
        if hit is not None:
            answers.append(hit)
    router.pump()
    router.drain()
    wall = time.perf_counter() - t_wall
    for t, ans in sorted(router.take_results().items()):
        if not ans.cached:  # cached answers were collected at submit
            answers.append(ans)
    return answers, summarize(answers, wall_s=wall)


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p)) if xs else 0.0


def summarize(answers, *, wall_s: float) -> dict:
    """Latency/throughput/caching summary of a replayed workload."""
    by_kind: dict[str, list] = {}
    for a in answers:
        by_kind.setdefault(a.query.kind, []).append(a)
    kinds = {}
    for kind, group in sorted(by_kind.items()):
        lat = [a.latency_s for a in group]
        kinds[kind] = {
            "count": len(group),
            "cached": sum(a.cached for a in group),
            "p50_ms": _pct(lat, 50) * 1e3,
            "p99_ms": _pct(lat, 99) * 1e3,
            "mean_batch": float(np.mean([a.batch for a in group
                                         if not a.cached] or [0])),
        }
    lat = [a.latency_s for a in answers]
    return {
        "completed": len(answers),
        "cached": sum(a.cached for a in answers),
        "p50_ms": _pct(lat, 50) * 1e3,
        "p99_ms": _pct(lat, 99) * 1e3,
        "wall_s": wall_s,
        "throughput_qps": len(answers) / wall_s if wall_s > 0 else 0.0,
        "kinds": kinds,
    }
