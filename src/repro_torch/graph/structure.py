"""Graph containers for the GX-Plug engine.

Edge-centric storage (the daemon-side strategy of the paper, Sec. II-B):
edges are the primary objects; vertices carry attribute/state arrays.
Host-side arrays are numpy (the "vertex table"/"edge table" of an agent);
device-side views are materialized per edge block (see core/blocks.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """An immutable directed graph in COO form.

    Attributes:
      num_vertices: |V|.
      src, dst: int32 arrays of shape (E,).
      weights: optional float32 array of shape (E,) (edge attributes).
    """

    num_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weights: np.ndarray | None = None

    def __post_init__(self):
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.src.dtype != np.int32 or self.dst.dtype != np.int32:
            raise ValueError("src/dst must be int32")
        if self.weights is not None and self.weights.shape != self.src.shape:
            raise ValueError("weights shape mismatch")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.float32)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.float32)

    def sorted_by_src(self) -> "Graph":
        """Returns an edge-permuted copy with edges grouped by source vertex.

        This is the layout agents use to build edge blocks: "an agent selects
        a vertex and retrieves its outer edges" (paper Sec. II-B).
        """
        order = np.argsort(self.src, kind="stable")
        return Graph(
            num_vertices=self.num_vertices,
            src=self.src[order],
            dst=self.dst[order],
            weights=None if self.weights is None else self.weights[order],
        )

    def with_reverse_edges(self) -> "Graph":
        """Symmetrizes the graph (used by WCC / undirected algorithms)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = None
        if self.weights is not None:
            w = np.concatenate([self.weights, self.weights])
        return Graph(self.num_vertices, src.astype(np.int32), dst.astype(np.int32), w)

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, edge_order) grouping edges by src; weights/dst follow order."""
        order = np.argsort(self.src, kind="stable")
        counts = np.bincount(self.src, minlength=self.num_vertices)
        indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, order

    def sorted_by_dst(self) -> "Graph":
        """Returns an edge-permuted copy with edges grouped by destination.

        The daemon-side merge is per-destination (MSGMerge), so grouping
        edges by dst turns the segmented reduce into a sorted-segment
        reduce — the layout the fused CSR aggregation kernel consumes
        (graph/compaction.py).
        """
        order = np.argsort(self.dst, kind="stable")
        return Graph(
            num_vertices=self.num_vertices,
            src=self.src[order],
            dst=self.dst[order],
            weights=None if self.weights is None else self.weights[order],
        )

    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, edge_order) grouping edges by dst (the transpose of
        :meth:`csr`); src/weights follow order.  This is the in-edge view
        the CSR tile compaction walks when it packs rows into tiles."""
        order = np.argsort(self.dst, kind="stable")
        counts = np.bincount(self.dst, minlength=self.num_vertices)
        indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, order


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """The slice of a graph owned by one agent (distributed node).

    Vertex state is replicated across agents (PowerGraph-style mirrors, with
    the monoid merge resolving contributions); edges are disjointly owned.

    Attributes:
      shard_id: which agent this is.
      src, dst, weights: this shard's edges (global vertex ids).
      num_vertices: global |V|.
      boundary_mask: (N,) bool — vertices whose out-edges are NOT all local
        to this shard ("conflict" vertices in the paper's sync-skipping
        terminology, Sec. III-B3). An update to a non-boundary (interior)
        vertex need not be synchronized eagerly.
    """

    shard_id: int
    num_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weights: np.ndarray | None
    boundary_mask: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])
