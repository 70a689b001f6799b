"""Online graph-query serving over the resident graph, in PyTorch (the JAX
package's ``serve``).

The first online workload axis of the reproduction: requests (k-hop
neighborhood, single/multi-seed shortest path, personalized PageRank,
label/state lookup) are admitted into a micro-batch queue, compiled as
*multi-source* variants of the offline algorithms — a ``(B, N)``
frontier stack instead of ``(N,)``, one fused step answering a whole
batch — and cached in a result LRU with explicit invalidation wired to
the elastic remesh/migration hooks.  The family middlewares run on the
card (``device="cuda"``, the default) through ``ShardedDaemon``; with
``kernel="cuda"`` the CSR-tile kernel runs once a fused iteration at
K = the batch's bucket.

    from repro_torch import serve
    session = serve.GraphServeSession(graph, num_shards=8, kernel="cuda")
    router = serve.GraphServeRouter(session)
    t, hit = router.submit(serve.Query.make("sssp", 42))
    router.clock.advance(0.01); router.pump()
    answer = router.result(t)          # (N,) distances from vertex 42
"""
from repro_torch.serve.cache import CacheStats, ServeCache
from repro_torch.serve.queue import AdmissionQueue, Query, VirtualClock
from repro_torch.serve.router import Answer, GraphServeRouter
from repro_torch.serve.session import (BATCH_KINDS, LOOKUP_FIELDS,
                                       GraphServeSession)
from repro_torch.serve.workload import generate_workload, replay, summarize

__all__ = [
    "AdmissionQueue",
    "Answer",
    "BATCH_KINDS",
    "CacheStats",
    "GraphServeRouter",
    "GraphServeSession",
    "LOOKUP_FIELDS",
    "Query",
    "ServeCache",
    "VirtualClock",
    "generate_workload",
    "replay",
    "summarize",
]
