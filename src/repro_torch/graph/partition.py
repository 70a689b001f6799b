"""Edge-centric graph partitioning.

The upper system partitions edges to distributed nodes (agents). We provide:

  * ``partition_contiguous`` — edges sorted by src, contiguous ranges with
    *target fractions* per shard. With uniform fractions this is the
    paper's "evenly partition" default; with Lemma-2 fractions
    (``repro_torch.core.balance.lemma2_fractions``) it is the capacity-balanced
    strategy of Sec. III-C Case 1.
  * ``partition_hash`` — hash of src vertex → shard (the GraphX-style
    default; destroys locality, useful as a contrast for sync skipping).

Both keep all out-edges of a vertex in one shard whenever possible
(contiguous does by construction; hash does by keying on src), which is the
precondition the paper exploits for synchronization skipping.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import EdgePartition, Graph


def _boundary_masks(
    graph: Graph, shard_of_edge: np.ndarray, num_shards: int
) -> list[np.ndarray]:
    """boundary[v] on shard j == some *other* shard holds an edge with src v
    or v is a destination updated elsewhere; i.e. v's value must be visible
    beyond shard j. Conservative and cheap: a vertex is interior to shard j
    iff *all* edges touching it (as src) live on j and all its in-edges
    live on j."""
    n = graph.num_vertices
    out_owner_min = np.full(n, num_shards, dtype=np.int32)
    out_owner_max = np.full(n, -1, dtype=np.int32)
    np.minimum.at(out_owner_min, graph.src, shard_of_edge)
    np.maximum.at(out_owner_max, graph.src, shard_of_edge)
    in_owner_min = np.full(n, num_shards, dtype=np.int32)
    in_owner_max = np.full(n, -1, dtype=np.int32)
    np.minimum.at(in_owner_min, graph.dst, shard_of_edge)
    np.maximum.at(in_owner_max, graph.dst, shard_of_edge)
    masks = []
    for j in range(num_shards):
        touches_out = (out_owner_max >= 0) & ((out_owner_min != j) | (out_owner_max != j))
        touches_in = (in_owner_max >= 0) & ((in_owner_min != j) | (in_owner_max != j))
        # A vertex is boundary for shard j if any edge touching it lives on
        # another shard (then j's updates to it are needed elsewhere, or j
        # sees only partial in-flow for it).
        masks.append(touches_out | touches_in)
    return masks


def _build(graph: Graph, shard_of_edge: np.ndarray, num_shards: int) -> list[EdgePartition]:
    masks = _boundary_masks(graph, shard_of_edge, num_shards)
    parts = []
    for j in range(num_shards):
        sel = shard_of_edge == j
        parts.append(
            EdgePartition(
                shard_id=j,
                num_vertices=graph.num_vertices,
                src=graph.src[sel],
                dst=graph.dst[sel],
                weights=None if graph.weights is None else graph.weights[sel],
                boundary_mask=masks[j],
            )
        )
    return parts


def partition_contiguous(
    graph: Graph,
    num_shards: int,
    fractions: np.ndarray | None = None,
) -> list[EdgePartition]:
    """Contiguous src-sorted edge ranges; ``fractions`` sum to 1 (Lemma 2)."""
    g = graph.sorted_by_src()
    e = g.num_edges
    if fractions is None:
        fractions = np.full(num_shards, 1.0 / num_shards)
    fractions = np.asarray(fractions, dtype=np.float64)
    fractions = fractions / fractions.sum()
    cuts = np.floor(np.cumsum(fractions) * e).astype(np.int64)
    cuts[-1] = e
    starts = np.concatenate([[0], cuts[:-1]])
    shard_of_edge = np.zeros(e, dtype=np.int32)
    for j, (s, t) in enumerate(zip(starts, cuts)):
        shard_of_edge[s:t] = j
    # keep all out-edges of one src in one shard: snap cut points to src runs
    for j in range(1, num_shards):
        cut = int(starts[j])
        if 0 < cut < e and g.src[cut - 1] == g.src[cut]:
            v = g.src[cut]
            run_start = int(np.searchsorted(g.src, v, side="left"))
            shard_of_edge[run_start:cut] = shard_of_edge[cut]
    return _build(g, shard_of_edge, num_shards)


def partition_hash(graph: Graph, num_shards: int, *, seed: int = 0x9E3779B9) -> list[EdgePartition]:
    """Hash-of-src sharding (keeps a vertex's out-edges together)."""
    h = (graph.src.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed))
    shard_of_edge = ((h >> np.uint64(33)) % np.uint64(num_shards)).astype(np.int32)
    return _build(graph, shard_of_edge, num_shards)


PARTITIONERS = {
    "contiguous": partition_contiguous,
    "hash": partition_hash,
}


def super_shard_cuts(num_cols: int, hot_cols: int, cols_per_super: int
                     ) -> tuple[slice, list[slice]]:
    """Column ranges of an out-of-core layout over a hot-first ordering.

    Columns are whole blocks (or whole CSR tiles), so every cut here is
    tile-aligned: the resident prefix ``[0, hot_cols)`` and equal-width
    cold groups covering the rest.  The final group may be short — the
    caller pads it with dead columns so all super-shards share one shape.
    """
    if not 0 <= hot_cols <= num_cols:
        raise ValueError(f"hot_cols={hot_cols} outside [0, {num_cols}]")
    cold = num_cols - hot_cols
    if cold and cols_per_super < 1:
        raise ValueError("cols_per_super must be >= 1 when cold columns exist")
    cold_slices = [slice(lo, min(lo + cols_per_super, num_cols))
                   for lo in range(hot_cols, num_cols, cols_per_super)] if cold else []
    return slice(0, hot_cols), cold_slices
