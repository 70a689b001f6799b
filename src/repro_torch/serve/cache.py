"""Result/frontier LRU for the serving layer (the JAX package's
``serve/cache.py``; no device code).

Keyed like the sync-cache (``core.sync.LRUVertexCache``): bounded,
recency-evicted, with EXPLICIT invalidation mirroring the graph_accel
contract — the cache never guesses at staleness, the owner of the
mutation tells it.  Two invalidation channels:

* :meth:`invalidate` (vertex ids) — a graph/state mutation touched
  these vertices; every entry whose dependency set intersects them is
  dropped.  This is the ``graph_accel_invalidate`` mirror and the seam
  a future mutation log plugs into.
* :meth:`flush_volatile` — the shard axis changed under the entries (a
  migration after a kill, or an elastic join).  Entries inserted as
  ``durable`` survive: the batched min-monoid programs are bit-identical
  across a migration (kill-recovery equivalence), so their answers
  cannot go stale when devices move.  Volatile entries — sum-monoid results
  and anything proxying device-resident state — are dropped.  This is
  what "migration flushes only the AFFECTED entries" means: the
  bit-identity guarantee, not a heuristic, decides who survives.

Sound caching at all requires answers independent of batch composition;
that is exactly the ``BatchQueryCapable`` per-query freeze contract
(see ``plug.protocols``), which is why this cache lives next to it.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evicted: int = 0
    invalidated: int = 0
    flushed: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Entry:
    value: object
    deps: np.ndarray | None  # vertex ids this answer depends on;
    #                          None = global support (any mutation hits)
    durable: bool     # survives a mesh migration (bit-identity guarantee)


class ServeCache:
    """Bounded LRU of query answers with explicit invalidation."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be ≥ 1")
        self.capacity = int(capacity)
        self._entries: collections.OrderedDict[tuple, _Entry] = (
            collections.OrderedDict())
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def lookup(self, key):
        """The answer for ``key``, or None.  A hit refreshes recency."""
        entry = self._entries.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return entry.value

    def insert(self, key, value, *, deps=(), durable: bool = True) -> None:
        """Caches ``value`` under ``key``.

        deps: vertex ids the answer depends on — consulted by
          :meth:`invalidate`.  The honest choice is the answer's
          *support* (``serve.session.answer_deps``): every vertex whose
          mutation could change the answer, not just the seeds.  An
          empty set means "never invalidated by vertex mutation";
          ``None`` means global support — ANY vertex mutation drops the
          entry (converged analytics fields served by lookup queries).
        durable: False marks the entry placement-dependent; it is
          dropped by :meth:`flush_volatile` on migration.
        """
        self._entries[key] = _Entry(
            value=value,
            deps=(None if deps is None else np.asarray(
                sorted({int(d) for d in deps}), dtype=np.int64)),
            durable=bool(durable))
        self._entries.move_to_end(key)
        self.stats.inserts += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evicted += 1

    def invalidate(self, vertex_ids) -> int:
        """Drops every entry whose dependency set intersects
        ``vertex_ids`` (the graph_accel ``invalidate`` contract); returns
        how many were dropped."""
        ids = np.asarray(list(vertex_ids), dtype=np.int64)
        if ids.size == 0 or not self._entries:
            return 0
        drop = [k for k, e in self._entries.items()
                if e.deps is None
                or (e.deps.size and np.isin(e.deps, ids).any())]
        for k in drop:
            del self._entries[k]
        self.stats.invalidated += len(drop)
        return len(drop)

    def flush_volatile(self, dirty=None) -> int:
        """Migration hook: drops non-durable entries (answers whose
        validity depended on the old placement), keeps the rest; returns
        how many were dropped.

        ``dirty`` scopes the flush to the vertices the migration's
        structure epoch actually touched: a pure re-placement that moved
        only some shards between devices affects only answers whose
        dependency set intersects the moved shards' destinations, so
        volatile entries outside the dirty region survive.  ``None``
        (no epoch metadata, a re-partition, or a changed mesh size)
        keeps the global flush.  Dep-less volatile entries are always
        dropped — "no deps" means "never invalidated by vertex
        mutation", not "placement-independent".
        """
        if dirty is None:
            drop = [k for k, e in self._entries.items() if not e.durable]
        else:
            ids = np.asarray(list(dirty), dtype=np.int64)
            drop = [k for k, e in self._entries.items()
                    if not e.durable
                    and (e.deps is None or e.deps.size == 0
                         or np.isin(e.deps, ids).any())]
        for k in drop:
            del self._entries[k]
        self.stats.flushed += len(drop)
        return len(drop)

    def clear(self) -> None:
        self._entries.clear()
