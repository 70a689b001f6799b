"""The serving front door: submit → cache/queue → batch → answer (the JAX
package's ``serve/router.py``).

The :class:`GraphServeRouter` composes the three serving pieces —
admission queue, result cache, device session — into one dataflow:

1. ``submit(query)``: a cache hit answers immediately; a miss is
   admitted into the micro-batch queue.
2. ``pump()``: flushes the batches the admission policy says are due
   *now* (virtual time), executes each through the session's fused
   middleware, caches the answers, and completes the tickets.
3. ``drain()``: end of a request window — force-flushes everything.

Latency accounting keeps the determinism contract: the QUEUE component
of a query's latency is virtual (decided by the seeded clock and the
admission policy — reproducible in CI), the SERVICE component is the
measured wall time of the fused run it rode in.  The two are reported
separately and summed into ``latency_s``; nothing wall-clock ever feeds
back into an admission decision.

Migration hook: any migration a batch observed (a device kill's
shrink, or an elastic join) flushes the cache's volatile entries —
durable (idempotent-monoid) answers survive by the bit-identity
guarantee; see ``serve.cache``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.cache import ServeCache
from repro_torch.serve.queue import AdmissionQueue, Query, VirtualClock
from repro_torch.serve.session import GraphServeSession, answer_deps


@dataclasses.dataclass
class Answer:
    """A completed query."""

    query: Query
    value: np.ndarray
    cached: bool            # answered from the result cache
    queue_wait_s: float     # virtual: admission → batch flush
    service_s: float        # wall: the fused run this query rode in
    batch: int              # how many queries shared that run
    iterations: int

    @property
    def latency_s(self) -> float:
        return self.queue_wait_s + self.service_s


class GraphServeRouter:
    """Queue + cache + session composed into one serving loop."""

    def __init__(self, session: GraphServeSession, *,
                 max_batch: int | None = None, max_wait: float = 0.005,
                 clock: VirtualClock | None = None,
                 cache_capacity: int = 256):
        self.session = session
        self.clock = clock or VirtualClock()
        self.queue = AdmissionQueue(
            max_batch=max_batch or session.max_batch, max_wait=max_wait,
            clock=self.clock)
        self.cache = ServeCache(cache_capacity)
        self._done: dict[int, Answer] = {}
        self._next_hit_ticket = -1  # cache hits get negative tickets

    # -- submission --------------------------------------------------------
    def submit(self, query: Query) -> tuple[int, Answer | None]:
        """Admits one query.  Returns ``(ticket, answer)`` — ``answer``
        is non-None iff the cache already held it (zero queue wait, zero
        service: the hit path never touches the mesh)."""
        hit = self.cache.lookup(query.cache_key)
        if hit is not None:
            ticket = self._next_hit_ticket
            self._next_hit_ticket -= 1
            ans = Answer(query=query, value=hit, cached=True,
                         queue_wait_s=0.0, service_s=0.0, batch=0,
                         iterations=0)
            self._done[ticket] = ans
            return ticket, ans
        return self.queue.submit(query), None

    # -- execution ---------------------------------------------------------
    def _run_batch(self, pendings) -> None:
        queries = [p.query for p in pendings]
        fam = queries[0]
        now = self.clock.now()
        answers, record = self.session.execute_batch(
            fam.kind, fam.params, [q.seeds for q in queries])
        if record["migrations"]:
            # the mesh changed under us: drop exactly the entries whose
            # validity depended on the old placement, keep the rest.
            # A pure re-placement's epoch says which vertices moved
            # device groups; flushing is scoped to them.  Any migration
            # without that metadata (an analytics run's, a re-partition,
            # a resized mesh: dirty_vertices None) falls back to the
            # global volatile flush.
            dirty: set[int] | None = set()
            for m in record["migrations"]:
                dv = m.get("dirty_vertices")
                if dv is None:
                    dirty = None
                    break
                dirty.update(int(v) for v in dv)
            self.cache.flush_volatile(dirty)
        per_query_service = record["service_s"]
        for p, q, value in zip(pendings, queries, answers):
            # deps = the answer's support, not its seeds: mutation
            # invalidation must catch edges added anywhere the
            # propagation reached (serve.session.answer_deps)
            self.cache.insert(q.cache_key, value,
                              deps=answer_deps(q.kind, q.seeds, value),
                              durable=record["durable"])
            self._done[p.ticket] = Answer(
                query=q, value=value, cached=False,
                queue_wait_s=now - p.admitted,
                service_s=per_query_service,
                batch=record["batch"], iterations=record["iterations"])

    def pump(self) -> int:
        """Runs every batch due at the current virtual time; returns how
        many queries completed."""
        n = 0
        for batch in self.queue.poll():
            self._run_batch(batch)
            n += len(batch)
        return n

    def drain(self) -> int:
        """Force-flushes everything still queued (end of window)."""
        n = 0
        for batch in self.queue.drain():
            self._run_batch(batch)
            n += len(batch)
        return n

    # -- dynamic graphs ----------------------------------------------------
    def mutate(self, batch) -> dict:
        """Applies a mutation batch to the served graph and invalidates
        exactly the cache entries whose dependency set — the answer's
        reached *support*, plus every lookup entry (global analytics
        support) — intersects the dirty region, durable and volatile
        alike: a mutation changes answers, unlike a migration, so the
        bit-identity guarantee that lets durable entries survive a
        re-placement does not apply here."""
        dirty = self.session.apply_mutations(batch)
        dropped = self.cache.invalidate(dirty)
        return {"dirty_vertices": int(dirty.size),
                "entries_dropped": int(dropped)}

    # -- results -----------------------------------------------------------
    def result(self, ticket: int) -> Answer | None:
        return self._done.get(ticket)

    def take_results(self) -> dict[int, Answer]:
        """Removes and returns every completed answer."""
        out, self._done = self._done, {}
        return out
