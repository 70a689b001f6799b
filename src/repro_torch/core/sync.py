"""Inter-iteration optimization: synchronization caching & skipping
(paper Sec. III-B).

Mapping to the host drive loop (see DESIGN.md §2):

* "upper system synchronization" ≙ the cross-shard combine of per-shard
  message aggregates (a collective round / host-side merge).
* **Lazy uploading** — instead of exchanging the dense (N, K) aggregate,
  each shard announces the vertex ids it *queries* next iteration (global
  query queue) and uploads only its *updated* vertices that appear in some
  query (global data queue). Payloads are index+value pairs; we account
  exchanged bytes exactly.
* **LRU caching** — each agent holds a bounded cache of *remote boundary*
  vertex values with recency weights (decayed each iteration, bumped on
  use); interior vertices are local and never "downloaded". Cache hits
  avoid re-downloading unchanged vertices from the upper system.
* **Synchronization skipping** — if, on every shard, every vertex updated
  this iteration is interior (all of its edges are shard-local), no shard
  needs any other shard's update: the global round is skipped and shards
  proceed on local state. Only *idempotent* monoids (min/max) are eligible
  (sum aggregates would double-count under divergent replicas); the paper
  evaluates skipping on SSSP-BF, which is min-monoid — consistent.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyncStats:
    """Byte/round accounting for EXPERIMENTS.md §Sync (Fig. 11 analogue)."""

    rounds_total: int = 0
    rounds_skipped: int = 0
    dense_bytes: int = 0  # what a naive dense exchange would have moved
    lazy_bytes: int = 0  # what lazy upload actually moved
    cache_hits: int = 0
    cache_misses: int = 0
    download_bytes_nocache: int = 0
    download_bytes_cache: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LRUVertexCache:
    """Agent-side bounded cache of remote boundary vertex values.

    Weights: every cached vertex's weight decays by 1 per iteration and is
    bumped to ``bump`` on use (paper: decreases with the passage of
    iterations, increases if used). Eviction removes the lowest weight.
    Vectorized over id arrays — iteration-time work is O(|request|).
    """

    def __init__(self, capacity: int, bump: float = 8.0):
        self.capacity = int(capacity)
        self.bump = float(bump)
        self._ids = np.empty(0, dtype=np.int64)
        self._weights = np.empty(0, dtype=np.float64)

    def __len__(self) -> int:
        return int(self._ids.shape[0])

    def tick(self) -> None:
        self._weights -= 1.0

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Returns bool mask of hits; bumps hit weights."""
        if self._ids.size == 0 or ids.size == 0:
            return np.zeros(ids.shape[0], dtype=bool)
        pos = np.searchsorted(self._ids, ids)
        pos = np.clip(pos, 0, self._ids.size - 1)
        hit = self._ids[pos] == ids
        self._weights[pos[hit]] = self.bump
        return hit

    def insert(self, ids: np.ndarray) -> None:
        """Inserts (or refreshes) ids, evicting lowest-weight entries."""
        if ids.size == 0:
            return
        merged_ids = np.concatenate([self._ids, ids])
        merged_w = np.concatenate([self._weights, np.full(ids.shape[0], self.bump)])
        order = np.argsort(merged_ids, kind="stable")
        merged_ids = merged_ids[order]
        merged_w = merged_w[order]
        # dedupe keeping max weight
        uniq, start = np.unique(merged_ids, return_index=True)
        w = np.maximum.reduceat(merged_w, start)
        if uniq.size > self.capacity:
            keep = np.argsort(w)[-self.capacity:]
            keep.sort()
            uniq, w = uniq[keep], w[keep]
        self._ids, self._weights = uniq, w

    def invalidate(self, ids: np.ndarray) -> None:
        if ids.size == 0 or self._ids.size == 0:
            return
        keep = ~np.isin(self._ids, ids, assume_unique=False)
        self._ids, self._weights = self._ids[keep], self._weights[keep]


def lazy_exchange_plan(
    updated_ids: list[np.ndarray],
    queried_ids: list[np.ndarray],
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Algorithm 3 (lazy uploading).

    Args:
      updated_ids: per-shard vertex ids whose value changed this iteration
        (and are boundary — interior updates never upload).
      queried_ids: per-shard vertex ids the shard will read next iteration
        and does not own authoritatively (boundary reads).

    Returns:
      (global_query_queue, uploads): the union of queries, and per-shard
      upload id lists = updated ∩ global queries (what lands on the global
      data queue).
    """
    if queried_ids:
        gqq = np.unique(np.concatenate([q for q in queried_ids if q.size] or
                                       [np.empty(0, dtype=np.int64)]))
    else:
        gqq = np.empty(0, dtype=np.int64)
    uploads = []
    for upd in updated_ids:
        uploads.append(upd[np.isin(upd, gqq, assume_unique=False)] if upd.size else upd)
    return gqq, uploads


def can_skip_sync(updated_ids: list[np.ndarray], boundary_masks: list[np.ndarray]) -> bool:
    """Sync skipping predicate (Sec. III-B3): true iff every updated vertex
    on every shard is interior to that shard."""
    for upd, boundary in zip(updated_ids, boundary_masks):
        if upd.size and bool(boundary[upd].any()):
            return False
    return True
