"""Synthetic graph generators.

The paper evaluates on real social/web graphs (power-law) and on uniform
random synthetic graphs; the *contrast* between the two matters (sync
skipping helps on clustered/power-law graphs, not on uniform ones —
Fig. 11b). We generate both families:

  * ``rmat``        — Kronecker/R-MAT power-law graphs (clustered).
  * ``rmat_stream`` — the same distribution generated in fixed-size chunks
                      into preallocated int32 edge lists (~12 B/edge peak);
                      use it for the >10⁷-edge out-of-core inputs.
  * ``uniform``     — Erdos-Renyi-style uniform random graphs.
  * ``clustered``   — planted-partition graphs with dense communities and a
                      controllable fraction of cross-community edges; this
                      directly drives the sync-skipping benchmark.
  * ``grid_road``   — 2D lattice with random diagonals (road-network-like,
                      low degree, high diameter — the WRN analogue).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph


def _dedup(src: np.ndarray, dst: np.ndarray, num_vertices: int):
    key = src.astype(np.int64) * num_vertices + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx]


def rmat(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weighted: bool = True,
    dedup: bool = True,
) -> Graph:
    """R-MAT generator: power-law degree distribution, community structure."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    n = 1 << scale
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    probs = np.array([a, b, c, 1.0 - a - b - c])
    for level in range(scale):
        quad = rng.choice(4, size=num_edges, p=probs)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
        del quad
    src = (src % num_vertices).astype(np.int32)
    dst = (dst % num_vertices).astype(np.int32)
    if dedup:
        src, dst = _dedup(src, dst, num_vertices)
    w = rng.uniform(1.0, 10.0, size=src.shape[0]).astype(np.float32) if weighted else None
    return Graph(num_vertices, src, dst, w)


def uniform(
    num_vertices: int, num_edges: int, *, seed: int = 0, weighted: bool = True
) -> Graph:
    """Uniform random digraph (the paper's 'synthetic' contrast case)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges, dtype=np.int32)
    dst = rng.integers(0, num_vertices, size=num_edges, dtype=np.int32)
    src, dst = _dedup(src, dst, num_vertices)
    w = rng.uniform(1.0, 10.0, size=src.shape[0]).astype(np.float32) if weighted else None
    return Graph(num_vertices, src, dst, w)


def clustered(
    num_vertices: int,
    num_edges: int,
    *,
    num_clusters: int = 8,
    p_cross: float = 0.05,
    seed: int = 0,
    weighted: bool = True,
) -> Graph:
    """Planted-partition graph: (1 - p_cross) of edges stay inside a cluster.

    With cluster-aligned partitioning, interior updates dominate and the
    sync-skipping mechanism triggers often — mirroring the paper's
    observation that real (clustered) graphs skip 60-90% of syncs.
    """
    rng = np.random.default_rng(seed)
    cluster = rng.integers(0, num_clusters, size=num_vertices)
    cluster.sort()  # contiguous clusters → contiguous partitions align
    members: list[np.ndarray] = [np.where(cluster == k)[0] for k in range(num_clusters)]
    members = [m for m in members if m.size > 0]
    srcs, dsts = [], []
    cross = rng.random(num_edges) < p_cross
    owner = rng.integers(0, len(members), size=num_edges)
    for k, m in enumerate(members):
        mask = owner == k
        n_k = int(mask.sum())
        if n_k == 0:
            continue
        s = m[rng.integers(0, m.size, size=n_k)]
        d_in = m[rng.integers(0, m.size, size=n_k)]
        d_out = rng.integers(0, num_vertices, size=n_k)
        d = np.where(cross[mask], d_out, d_in)
        srcs.append(s)
        dsts.append(d)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    src, dst = _dedup(src, dst, num_vertices)
    w = rng.uniform(1.0, 10.0, size=src.shape[0]).astype(np.float32) if weighted else None
    return Graph(num_vertices, src, dst, w)


def grid_road(side: int, *, seed: int = 0, weighted: bool = True) -> Graph:
    """2D lattice with bidirectional edges — road-network analogue (WRN)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int32)
    srcs, dsts = [], []
    right = jj < side - 1
    srcs += [vid[right], (vid + 1)[right]]
    dsts += [(vid + 1)[right], vid[right]]
    down = ii < side - 1
    srcs += [vid[down], (vid + side)[down]]
    dsts += [(vid + side)[down], vid[down]]
    src = np.concatenate([s.ravel() for s in srcs]).astype(np.int32)
    dst = np.concatenate([d.ravel() for d in dsts]).astype(np.int32)
    w = rng.uniform(1.0, 10.0, size=src.shape[0]).astype(np.float32) if weighted else None
    return Graph(n, src, dst, w)


# rmat_stream's internal chunk: big enough to amortize RNG setup, small
# enough that scratch (three int64 + one float64 array of this length)
# stays ~8 MB regardless of graph size
_STREAM_CHUNK = 1 << 18


def rmat_stream(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weighted: bool = True,
) -> Graph:
    """R-MAT at out-of-core scale: edge-list-native, fixed scratch.

    The level-major :func:`rmat` holds the whole edge list at int64
    through every recursion level plus a full-length quadrant draw —
    ~24 B/edge of working set before the final int32 cast, and a global
    sort on top when deduplicating.  This variant generates in fixed
    ~256 Ki-edge chunks straight into preallocated int32/float32 output
    (12 B/edge peak beyond one chunk of scratch), which is what makes
    >10⁷-edge inputs for the out-of-core benchmarks buildable at all.

    Chunks are seeded counter-style (``(seed, chunk_index)``), so the
    result is a pure function of ``seed`` — independent of chunk size
    and safely parallelizable.  No global dedup: at this scale R-MAT's
    duplicate multiplicity is part of the power-law weighting, and the
    fused kernels treat parallel edges like any others.
    """
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    probs = np.array([a, b, c, 1.0 - a - b - c])
    src = np.empty(num_edges, dtype=np.int32)
    dst = np.empty(num_edges, dtype=np.int32)
    w = np.empty(num_edges, dtype=np.float32) if weighted else None
    for ci, lo in enumerate(range(0, num_edges, _STREAM_CHUNK)):
        hi = min(lo + _STREAM_CHUNK, num_edges)
        rng = np.random.default_rng((seed, ci))
        s = np.zeros(hi - lo, dtype=np.int64)
        d = np.zeros(hi - lo, dtype=np.int64)
        for _ in range(scale):
            quad = rng.choice(4, size=hi - lo, p=probs)
            s = (s << 1) | (quad >> 1)
            d = (d << 1) | (quad & 1)
            del quad
        src[lo:hi] = s % num_vertices
        dst[lo:hi] = d % num_vertices
        if weighted:
            w[lo:hi] = rng.uniform(1.0, 10.0, size=hi - lo)
    return Graph(num_vertices, src, dst, w)


GENERATORS = {
    "rmat": rmat,
    "uniform": uniform,
    "clustered": clustered,
    "rmat_stream": rmat_stream,
}


def by_name(name: str, num_vertices: int, num_edges: int, **kw) -> Graph:
    if name == "grid_road":
        side = int(np.sqrt(num_vertices))
        return grid_road(side, **kw)
    return GENERATORS[name](num_vertices, num_edges, **kw)
