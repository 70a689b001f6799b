"""CSR/CSC tile compaction for the fused aggregation kernel (DESIGN.md §3.1).

The daemon-side merge is per-destination, so the natural device layout
groups a shard's edges by dst (the CSC view of ``Graph.csc``) and cuts
the sorted edge list into fixed-size *edge tiles*.  Each tile carries

  * a compact **row block** — the distinct destination vertices whose
    edges land in the tile (``rows``), with every edge addressing its
    row through a tile-local, *sorted* segment id (``seg``);
  * a compact **src block** — the distinct source vertices the tile
    reads (``svids``), addressed through tile-local ``lsrc`` indices;
  * the edge data itself (``w``, ``emask``) plus the global endpoints
    (``gsrc`` for frontier filtering, ``gdst`` for the flat fused
    combine).

Degree bucketing decides how rows map to tiles:

  * **low-degree rows** (in-degree ≤ ``hub_threshold``) are packed whole
    — a tile is cut early rather than letting a small row straddle the
    boundary, so each such row is merged entirely inside one tile;
  * **hub rows** (in-degree > ``hub_threshold``) are split across as
    many dedicated tiles as they need; the per-tile partials of a split
    row are finished by the cross-tile segmented combine
    (``kernels.ops.csr_aggregate``), which every variant runs anyway.

Tile shapes are uniform (ET edges, RT ≤ rows, ST ≤ srcs, both rounded to
multiples of 8, the JAX package's alignment, kept so both packages build
byte-identical layouts), so ONE kernel launch configuration serves every
tile of every shard.

All compaction is host-side numpy and happens once at bind time;
iteration-time work touches only the packed arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.blocks import BlockSet
from repro_torch.graph.structure import EdgePartition


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CSRTileSet:
    """Packed CSR/CSC tiles for one shard.  Leading axis = tile index.

    rows   (nt, RT)    int32  global dst ids of the tile's row block
    seg    (nt, ET)    int32  tile-local row index per edge (sorted ↑)
    lsrc   (nt, ET)    int32  tile-local src index into svids
    svids  (nt, ST)    int32  global src ids of the tile's src block
    w      (nt, ET, 1) f32    edge weights (1.0 if unweighted)
    emask  (nt, ET)    bool   valid edge slots
    gsrc   (nt, ET)    int32  global src ids (frontier filtering)
    gdst   (nt, ET)    int32  global dst ids (flat fused combine)
    eblock (nt, ET)    int32  owning edge-block id (block-granularity
                              frontier selection; -1 when not built
                              from a BlockSet)

    Padding convention (same as core/blocks.py): dead slots carry vertex
    id 0 with ``emask`` False / identity partials / zero counts, so
    padded work scatters monoid identities into vertex 0 — a no-op under
    every monoid — and one rectangular layout serves all tiles.
    """

    edge_tile: int   # ET
    row_tile: int    # RT
    src_tile: int    # ST
    num_tiles: int   # nt
    num_edges: int   # real (unpadded) edges
    num_vertices: int
    hub_threshold: int
    rows: np.ndarray
    seg: np.ndarray
    lsrc: np.ndarray
    svids: np.ndarray
    w: np.ndarray
    emask: np.ndarray
    gsrc: np.ndarray
    gdst: np.ndarray
    eblock: np.ndarray

    @property
    def padding_ratio(self) -> float:
        return 1.0 - self.num_edges / max(self.num_tiles * self.edge_tile, 1)

    def hub_rows(self) -> np.ndarray:
        """Global ids of rows split across more than one tile."""
        seen: dict[int, int] = {}
        for t in range(self.num_tiles):
            live = self.emask[t]
            for r in np.unique(self.gdst[t][live]):
                seen[int(r)] = seen.get(int(r), 0) + 1
        return np.asarray(sorted(r for r, c in seen.items() if c > 1),
                          dtype=np.int32)

    def arrays(self) -> dict:
        """The per-tile arrays as a dict pytree (daemon stacking order)."""
        return {"rows": self.rows, "seg": self.seg, "lsrc": self.lsrc,
                "svids": self.svids, "w": self.w, "emask": self.emask,
                "gsrc": self.gsrc, "gdst": self.gdst}


def _cut_tiles(dst_sorted: np.ndarray, edge_tile: int, hub_threshold: int
               ) -> list[np.ndarray]:
    """Degree-bucketed tiling of a dst-sorted edge index range.

    Returns a list of index arrays (positions into the sorted order),
    each of length ≤ edge_tile.  Low-degree rows never span a tile
    boundary; hub rows stream across consecutive (dedicated) tiles.
    """
    e = dst_sorted.size
    if e == 0:
        return [np.empty(0, np.int64)]
    # row runs in sorted order
    boundaries = np.flatnonzero(np.diff(dst_sorted)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [e]])
    tiles: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    cur_len = 0

    def close():
        nonlocal cur, cur_len
        if cur_len:
            tiles.append(np.concatenate(cur))
            cur, cur_len = [], 0

    for s, t in zip(starts, ends):
        run = t - s
        if run > hub_threshold:
            # hub row: stream-fill, spanning tiles; the segmented
            # cross-tile combine finishes the split row
            pos = s
            while pos < t:
                space = edge_tile - cur_len
                take = min(space, t - pos)
                cur.append(np.arange(pos, pos + take))
                cur_len += take
                pos += take
                if cur_len == edge_tile:
                    close()
        else:
            # low-degree row: packed whole — cut the tile early instead
            # of letting the row straddle the boundary
            if cur_len + run > edge_tile:
                close()
            cur.append(np.arange(s, t))
            cur_len += run
            if cur_len == edge_tile:
                close()
    close()
    return tiles or [np.empty(0, np.int64)]


def build_csr_tiles(src, dst, weights, num_vertices: int, *,
                    edge_tile: int = 512, hub_threshold: int | None = None,
                    eblock=None, align: int = 8) -> CSRTileSet:
    """Compacts an edge list into dst-grouped CSR tiles.

    Args:
      src, dst: int32 (E,) global endpoints (any order; sorted here).
      weights: float32 (E,) or None (treated as 1.0).
      num_vertices: global |V|.
      edge_tile: edges per tile (ET).
      hub_threshold: in-degree above which a row is split across
        dedicated tiles; defaults to ``edge_tile`` (a row that cannot
        fit one tile must split, everything smaller packs whole).
      eblock: optional int32 (E,) owning edge-block id per edge
        (block-granularity frontier selection for the host drive loop).
      align: RT/ST rounding multiple (8, as in the JAX package).
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    e = int(src.size)
    et = int(edge_tile)
    hub = et if hub_threshold is None else int(hub_threshold)
    if weights is None:
        weights = np.ones(e, dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    if eblock is None:
        eblock = np.full(e, -1, dtype=np.int32)
    eblock = np.asarray(eblock, dtype=np.int32)

    order = np.argsort(dst, kind="stable")
    dst_s = dst[order]
    tiles = _cut_tiles(dst_s, et, hub)
    nt = len(tiles)

    rows = np.zeros((nt, 1), np.int32)
    seg = np.zeros((nt, et), np.int32)
    lsrc = np.zeros((nt, et), np.int32)
    svids = np.zeros((nt, 1), np.int32)
    w = np.zeros((nt, et, 1), np.float32)
    emask = np.zeros((nt, et), bool)
    gsrc = np.zeros((nt, et), np.int32)
    gdst = np.zeros((nt, et), np.int32)
    ebk = np.full((nt, et), -1, np.int32)

    max_rows = max_srcs = 1
    per_tile: list[tuple[np.ndarray, np.ndarray]] = []
    for t, idx in enumerate(tiles):
        ed = order[idx]           # original edge indices of this tile
        ne = ed.size
        td = dst_s[idx]           # sorted within the tile by construction
        ts = src[ed]
        # distinct rows in sorted (ascending) first-occurrence order
        urows, inv = np.unique(td, return_inverse=True)
        usrc, sinv = np.unique(ts, return_inverse=True)
        per_tile.append((urows.astype(np.int32), usrc.astype(np.int32)))
        max_rows = max(max_rows, urows.size)
        max_srcs = max(max_srcs, usrc.size)
        seg[t, :ne] = inv
        lsrc[t, :ne] = sinv
        w[t, :ne, 0] = weights[ed]
        emask[t, :ne] = True
        gsrc[t, :ne] = ts
        gdst[t, :ne] = td
        ebk[t, :ne] = eblock[ed]

    rt = _round_up(max_rows, align)
    st = _round_up(max_srcs, align)
    rows = np.zeros((nt, rt), np.int32)
    svids = np.zeros((nt, st), np.int32)
    for t, (urows, usrc) in enumerate(per_tile):
        rows[t, : urows.size] = urows
        svids[t, : usrc.size] = usrc

    return CSRTileSet(
        edge_tile=et, row_tile=rt, src_tile=st, num_tiles=nt,
        num_edges=e, num_vertices=int(num_vertices), hub_threshold=hub,
        rows=rows, seg=seg, lsrc=lsrc, svids=svids, w=w, emask=emask,
        gsrc=gsrc, gdst=gdst, eblock=ebk)


def tiles_from_partition(part: EdgePartition, *, edge_tile: int = 512,
                         hub_threshold: int | None = None) -> CSRTileSet:
    """CSR tiles for one shard, straight from its edge partition."""
    return build_csr_tiles(part.src, part.dst, part.weights,
                           part.num_vertices, edge_tile=edge_tile,
                           hub_threshold=hub_threshold)


def tiles_from_blockset(bs: BlockSet, num_vertices: int, *,
                        edge_tile: int = 512,
                        hub_threshold: int | None = None) -> CSRTileSet:
    """CSR tiles over the real edges of an existing BlockSet.

    Every edge remembers its owning edge block (``eblock``), so the host
    drive loop's block-granularity frontier selection maps onto the CSR
    layout as a per-edge mask — identical skipping semantics, one fixed
    compiled shape instead of a padded-active-set bucket per size.
    """
    live = bs.emask.reshape(-1)
    src = bs.gsrc.reshape(-1)[live]
    dst = bs.gdst.reshape(-1)[live]
    w = bs.weights.reshape(-1)[live]
    blk = np.repeat(np.arange(bs.num_blocks, dtype=np.int32), bs.block_size)
    return build_csr_tiles(src, dst, w, num_vertices, edge_tile=edge_tile,
                           hub_threshold=hub_threshold, eblock=blk[live])


def pad_tileset(ts: CSRTileSet, *, num_tiles: int, row_tile: int,
                src_tile: int) -> CSRTileSet:
    """Pads a tile set to a common (nt, RT, ST) envelope (dead tiles /
    slots), so per-shard tile sets stack rectangularly on a shard axis.
    Dead slots follow the padding convention above; ``eblock`` reads -1
    there."""
    if (num_tiles < ts.num_tiles or row_tile < ts.row_tile
            or src_tile < ts.src_tile):
        raise ValueError(
            f"pad target ({num_tiles},{row_tile},{src_tile}) smaller than "
            f"({ts.num_tiles},{ts.row_tile},{ts.src_tile})")

    def pad(a, tile_dim, fill=0):
        out = np.full((num_tiles, tile_dim, *a.shape[2:]), fill, a.dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    return dataclasses.replace(
        ts, num_tiles=num_tiles, row_tile=row_tile, src_tile=src_tile,
        rows=pad(ts.rows, row_tile), seg=pad(ts.seg, ts.edge_tile),
        lsrc=pad(ts.lsrc, ts.edge_tile), svids=pad(ts.svids, src_tile),
        w=pad(ts.w, ts.edge_tile), emask=pad(ts.emask, ts.edge_tile),
        gsrc=pad(ts.gsrc, ts.edge_tile), gdst=pad(ts.gdst, ts.edge_tile),
        eblock=pad(ts.eblock, ts.edge_tile, fill=-1))


def src_adjacency(src, dst, weights, num_vertices: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Src-sorted CSR adjacency of one shard's edge list: the layout of the
    async loop's priority buckets, where a held device runs the out-edges
    ``dst[ptr[v]:ptr[v+1]]`` / ``w[ptr[v]:ptr[v+1]]`` of its top residual
    vertices v.

    Returns ``(ptr (N+1,) i32, dst (E,) i32, w (E,) f32)`` with the edges
    in a stable order by source.  Host numpy, built once per binding.
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if weights is None:
        weights = np.ones(src.size, dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=num_vertices)
    ptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return (ptr.astype(np.int32), dst[order].astype(np.int32),
            weights[order].astype(np.float32))


def tile_access_scores(gsrc: np.ndarray, emask: np.ndarray,
                       degrees: np.ndarray) -> np.ndarray:
    """Access-frequency proxy per edge group (CSR tile or padded block).

    A group's score is the summed out-degree of its live source vertices:
    groups touching hubs are re-read every iteration by every frontier that
    reaches the hub, so they are the ones worth keeping in the
    device-resident hot set.  Works on any ``(..., edges)`` layout —
    ``(nt, ET)`` for one tileset or ``(s, nt, ET)`` for a stack of shards.
    """
    return (degrees[gsrc] * emask).sum(axis=-1)


def take_tiles(ts: CSRTileSet, order: np.ndarray) -> CSRTileSet:
    """Reorders or selects whole tiles of a tileset (cuts stay
    tile-aligned)."""
    order = np.asarray(order, dtype=np.int64)
    return dataclasses.replace(
        ts, num_tiles=int(order.shape[0]),
        rows=ts.rows[order], seg=ts.seg[order], lsrc=ts.lsrc[order],
        svids=ts.svids[order], w=ts.w[order], emask=ts.emask[order],
        gsrc=ts.gsrc[order], gdst=ts.gdst[order], eblock=ts.eblock[order])
