"""Dynamic graphs, as in the JAX package's ``graph/mutation.py``: a batched
mutation log with deterministic application.

Production graphs mutate while being served (GraphX models this as a
sequence of graph versions over one substrate).  This module is the
host-side half of that story for the plug middleware:

* :class:`MutationLog` — the log: record edge/vertex adds and
  removes in any order; :meth:`MutationLog.freeze` canonicalizes them
  into an immutable :class:`MutationBatch`.
* :class:`MutationBatch` — the canonical form, applied in one
  deterministic order regardless of how the log was built:

  1. vertex additions grow ``num_vertices`` (new ids are appended —
     existing ids never shift);
  2. edge removals drop every matching ``(src, dst)`` copy, plus every
     edge incident to a removed vertex (vertex removal is a
     *tombstone*: the id slot survives so downstream state columns,
     partitions, and serve-cache keys stay aligned);
  3. edge additions append (duplicates allowed — the graph is a COO
     multigraph).

* :func:`apply_to_graph` — batch → new :class:`Graph` + the dirty
  vertex set (every endpoint the batch touched).
* :func:`apply_to_partitions` — the incremental path the middleware
  uses: each removal is dropped from the shard that owns it, each added
  edge lands on the shard already owning its source's out-edges (or a
  deterministic hash fallback for brand-new sources), boundary masks
  are recomputed globally, and only the shards whose edge content
  changed are reported dirty — their blocksets/tiles are recut, the
  clean shards' are reused untouched.
* :func:`dirty_frontier` — the incremental-restart seed: the touched
  vertices plus their out-neighbors, as a boolean (N,) mask.
* :class:`MutationSchedule` — the deterministic injection seam, shaped
  like ``dist.fault.FailureSchedule``: "apply batch b at iteration k",
  consumed by the fused drive loops between iterations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.partition import _boundary_masks
from repro_torch.graph.structure import EdgePartition, Graph


def _as_ids(a) -> np.ndarray:
    return np.asarray(list(a), dtype=np.int64).reshape(-1)


@dataclasses.dataclass(frozen=True)
class MutationBatch:
    """A canonicalized, immutable set of graph mutations.

    Built via :meth:`MutationLog.freeze`; the arrays are already sorted
    lexicographically so two logs describing the same mutations apply
    identically (the determinism the rebuild-equivalence tests pin).
    """

    add_src: np.ndarray
    add_dst: np.ndarray
    add_weights: np.ndarray | None
    remove_src: np.ndarray
    remove_dst: np.ndarray
    add_vertices: int = 0
    remove_vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))

    @property
    def num_added_edges(self) -> int:
        return int(self.add_src.size)

    @property
    def num_removed_edges(self) -> int:
        return int(self.remove_src.size)

    @property
    def has_removals(self) -> bool:
        """True when the batch deletes anything — the monotonicity
        breaker: converged min/max state may sit *below* the new fixed
        point once an edge it depended on is gone, so incremental
        restart must fall back to cold (see ``Middleware.run_dynamic``)."""
        return self.remove_src.size > 0 or self.remove_vertices.size > 0

    @property
    def empty(self) -> bool:
        return (self.add_src.size == 0 and self.remove_src.size == 0
                and self.add_vertices == 0
                and self.remove_vertices.size == 0)

    def touched(self) -> np.ndarray:
        """Every vertex id the batch names (endpoints of added and
        removed edges, removed vertices), unique-sorted."""
        return np.unique(np.concatenate([
            self.add_src, self.add_dst, self.remove_src, self.remove_dst,
            self.remove_vertices]))

    def validate(self, num_vertices: int) -> None:
        """Checks every id against the PRE-mutation ``num_vertices`` (+
        the batch's own vertex additions)."""
        n_new = num_vertices + self.add_vertices
        t = self.touched()
        if t.size and (t.min() < 0 or t.max() >= n_new):
            raise ValueError(
                f"mutation names vertex {int(t.max() if t.max() >= n_new else t.min())} "
                f"outside [0, {n_new}) (did you forget add_vertex()?)")
        if self.remove_vertices.size and self.remove_vertices.max() >= num_vertices:
            raise ValueError("cannot remove a vertex added in the same "
                             "batch — drop the add instead")


class MutationLog:
    """Mutable log accumulating one batch of updates."""

    def __init__(self):
        self._add: list[tuple[int, int, float]] = []
        self._remove: list[tuple[int, int]] = []
        self._add_vertices = 0
        self._remove_vertices: set[int] = set()

    def __len__(self) -> int:
        return (len(self._add) + len(self._remove) + self._add_vertices
                + len(self._remove_vertices))

    def add_edge(self, src: int, dst: int, weight: float = 1.0) -> "MutationLog":
        self._add.append((int(src), int(dst), float(weight)))
        return self

    def remove_edge(self, src: int, dst: int) -> "MutationLog":
        self._remove.append((int(src), int(dst)))
        return self

    def add_vertex(self, count: int = 1) -> "MutationLog":
        if count < 1:
            raise ValueError("count must be ≥ 1")
        self._add_vertices += int(count)
        return self

    def remove_vertex(self, v: int) -> "MutationLog":
        self._remove_vertices.add(int(v))
        return self

    def freeze(self) -> MutationBatch:
        """Canonical order: lexicographic (src, dst) for both add and
        remove lists — insertion order never matters."""
        adds = sorted(self._add)
        removes = sorted(set(self._remove))
        return MutationBatch(
            add_src=_as_ids([a[0] for a in adds]),
            add_dst=_as_ids([a[1] for a in adds]),
            add_weights=(np.asarray([a[2] for a in adds], np.float32)
                         if adds else None),
            remove_src=_as_ids([r[0] for r in removes]),
            remove_dst=_as_ids([r[1] for r in removes]),
            add_vertices=self._add_vertices,
            remove_vertices=_as_ids(sorted(self._remove_vertices)))


def _coerce(batch) -> MutationBatch:
    return batch.freeze() if isinstance(batch, MutationLog) else batch


def _pair_key(src, dst, n: int) -> np.ndarray:
    return np.asarray(src, np.int64) * np.int64(n) + np.asarray(dst, np.int64)


def _removal_mask(src, dst, batch: MutationBatch, n: int) -> np.ndarray:
    """Edges (over arbitrary src/dst arrays) the batch deletes."""
    drop = np.zeros(src.shape[0], dtype=bool)
    if batch.remove_src.size:
        drop |= np.isin(_pair_key(src, dst, n),
                        _pair_key(batch.remove_src, batch.remove_dst, n))
    if batch.remove_vertices.size:
        drop |= np.isin(src, batch.remove_vertices)
        drop |= np.isin(dst, batch.remove_vertices)
    return drop


def apply_to_graph(graph: Graph, batch) -> tuple[Graph, np.ndarray]:
    """Applies ``batch`` to ``graph``; returns ``(new_graph, dirty)``.

    ``dirty`` is the touched vertex set (sorted int64) — exactly what
    scoped cache invalidation consumes and what :func:`dirty_frontier`
    expands into the incremental-restart seed.
    """
    batch = _coerce(batch)
    batch.validate(graph.num_vertices)
    n_new = graph.num_vertices + batch.add_vertices
    keep = ~_removal_mask(graph.src, graph.dst, batch, n_new)
    src = graph.src[keep]
    dst = graph.dst[keep]
    w = None if graph.weights is None else graph.weights[keep]
    if batch.num_added_edges:
        src = np.concatenate([src, batch.add_src.astype(np.int32)])
        dst = np.concatenate([dst, batch.add_dst.astype(np.int32)])
        if graph.weights is not None:
            aw = (batch.add_weights if batch.add_weights is not None
                  else np.ones(batch.num_added_edges, np.float32))
            w = np.concatenate([w, aw.astype(np.float32)])
    g = Graph(num_vertices=n_new, src=src.astype(np.int32),
              dst=dst.astype(np.int32), weights=w)
    return g, batch.touched()


def dirty_frontier(graph: Graph, dirty_vertices) -> np.ndarray:
    """(N,) bool — the incremental-restart frontier: the touched
    vertices plus their out-neighbors on the POST-mutation graph.  A
    touched source must re-generate along its (possibly new) out-edges;
    its out-neighbors must re-apply so a lowered value keeps
    propagating."""
    mask = np.zeros(graph.num_vertices, dtype=bool)
    ids = _as_ids(dirty_vertices)
    mask[ids] = True
    out = mask[graph.src]
    mask[graph.dst[out]] = True
    return mask


def _owner_map(partitions: list[EdgePartition], num_vertices: int
               ) -> np.ndarray:
    """owner[v] = shard holding v's out-edges (first owner wins; -1 for
    sources with no current out-edges)."""
    owner = np.full(num_vertices, -1, dtype=np.int64)
    for p in reversed(partitions):
        owner[p.src] = p.shard_id
    return owner


def apply_to_partitions(graph: Graph, partitions: list[EdgePartition],
                        batch) -> tuple[Graph, list[EdgePartition],
                                        list[int], np.ndarray]:
    """The incremental structure update the middleware publishes.

    Returns ``(new_graph, new_partitions, dirty_shards, dirty_vertices)``.
    Edge placement is deterministic: a removal is dropped from whichever
    shards hold matching copies; an addition lands on the shard that
    already owns its source's out-edges (keeping the "all out-edges of a
    vertex on one shard" invariant partitioners establish), falling back
    to ``src % num_shards`` for brand-new sources.  ``dirty_shards``
    lists only the shards whose edge arrays changed — the caller recuts
    exactly those shards' blocks/tiles and reuses the rest untouched.
    Every partition object is still *replaced* (boundary masks are a
    global property and ``num_vertices`` may have grown), but a clean
    shard's edge arrays are reused by reference.
    """
    batch = _coerce(batch)
    new_graph, dirty = apply_to_graph(graph, batch)
    n_new = new_graph.num_vertices
    num_shards = len(partitions)
    owner = _owner_map(partitions, n_new)

    per_shard_edges = []
    dirty_shards = []
    add_owner = None
    if batch.num_added_edges:
        add_owner = owner[batch.add_src]
        fallback = add_owner < 0
        add_owner[fallback] = batch.add_src[fallback] % num_shards
    for j, p in enumerate(partitions):
        src, dst, w = p.src, p.dst, p.weights
        changed = False
        if batch.has_removals:
            drop = _removal_mask(src, dst, batch, n_new)
            if drop.any():
                keep = ~drop
                src, dst = src[keep], dst[keep]
                w = None if w is None else w[keep]
                changed = True
        if add_owner is not None:
            mine = add_owner == j
            if mine.any():
                src = np.concatenate([src,
                                      batch.add_src[mine].astype(np.int32)])
                dst = np.concatenate([dst,
                                      batch.add_dst[mine].astype(np.int32)])
                if w is not None:
                    aw = (batch.add_weights[mine]
                          if batch.add_weights is not None
                          else np.ones(int(mine.sum()), np.float32))
                    w = np.concatenate([w, aw.astype(np.float32)])
                changed = True
        per_shard_edges.append((src, dst, w))
        if changed:
            dirty_shards.append(j)

    # Boundary masks are global (a vertex is interior only if NO other
    # shard touches it), so recompute them over the full edge multiset —
    # cheap ints, no device work.
    all_src = np.concatenate([e[0] for e in per_shard_edges]
                             or [np.empty(0, np.int32)])
    all_dst = np.concatenate([e[1] for e in per_shard_edges]
                             or [np.empty(0, np.int32)])
    shard_of_edge = np.concatenate(
        [np.full(e[0].shape[0], j, np.int32)
         for j, e in enumerate(per_shard_edges)] or [np.empty(0, np.int32)])
    synth = Graph(num_vertices=n_new, src=all_src.astype(np.int32),
                  dst=all_dst.astype(np.int32))
    masks = _boundary_masks(synth, shard_of_edge, num_shards)
    new_parts = [
        EdgePartition(shard_id=j, num_vertices=n_new, src=src, dst=dst,
                      weights=w, boundary_mask=masks[j])
        for j, (src, dst, w) in enumerate(per_shard_edges)
    ]
    if sum(p.num_edges for p in new_parts) != new_graph.num_edges:
        raise AssertionError("partition update lost or duplicated edges")
    return new_graph, new_parts, dirty_shards, dirty


class MutationSchedule:
    """Deterministic mutation injection: apply batch ``b`` at iteration
    ``k`` — the dynamic-graph twin of ``dist.fault.FailureSchedule``.

    The fused drive loops poll it between iterations; an event
    ``(k, batch)`` fires at the first poll whose iteration is ≥ ``k``
    (the mutation lands *before* iteration ``k`` executes) and is
    consumed exactly once.  Mid-run batches may not grow
    ``num_vertices`` (the carried state's shape is compiled into the
    step); grow the graph between runs via
    ``Middleware.apply_mutations`` instead.
    """

    def __init__(self, events=()):
        evs = []
        for k, b in events:
            b = _coerce(b)
            if b.add_vertices:
                raise ValueError(
                    "a scheduled (mid-run) mutation cannot add vertices — "
                    "the carried state shape is fixed; use "
                    "Middleware.apply_mutations between runs")
            evs.append((int(k), b))
        self._events = sorted(evs, key=lambda e: e[0])
        self._next = 0

    def due_at(self, iteration: int) -> list[MutationBatch]:
        out = []
        while (self._next < len(self._events)
               and self._events[self._next][0] <= iteration):
            out.append(self._events[self._next][1])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next == len(self._events)

    def reset(self) -> None:
        self._next = 0
