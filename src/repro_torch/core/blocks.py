"""Edge blocks and paired vertex blocks (paper Sec. II-B).

A daemon consumes fixed-size *edge blocks*; each edge block is paired with a
*vertex block* containing every vertex referenced by its edges, and edges
address vertices through block-local indices (the "vertex-edge mapping
table"). Fixed shapes let one kernel launch configuration serve every
block; the edge-block kernel (kernels/edge_block.py) gathers through the
block-local indices and merges into the block's vertex slots.

A copy of the JAX package's host-side builder: the layout is byte-identical
(tests/test_torch_host.py).  Block construction happens once on the host
(agent side); iteration-time work touches only the packed arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import EdgePartition


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BlockSet:
    """Packed blocks for one shard. Leading axis = block index.

    vids    (nb, VB) int32  global vertex ids of each block's vertex block
    vmask   (nb, VB) bool   valid vertex slots
    lsrc    (nb, B)  int32  block-local src index of each edge
    ldst    (nb, B)  int32  block-local dst index of each edge
    weights (nb, B, 1) f32  edge weights (1.0 if unweighted)
    emask   (nb, B)  bool   valid edge slots
    gsrc    (nb, B)  int32  global src ids (frontier/activity checks)
    gdst    (nb, B)  int32  global dst ids (has-msg accounting)
    """

    block_size: int
    vblock_size: int
    num_blocks: int
    num_edges: int
    vids: np.ndarray
    vmask: np.ndarray
    lsrc: np.ndarray
    ldst: np.ndarray
    weights: np.ndarray
    emask: np.ndarray
    gsrc: np.ndarray
    gdst: np.ndarray

    @property
    def padding_ratio(self) -> float:
        return 1.0 - self.num_edges / max(self.num_blocks * self.block_size, 1)


def build_blocks(
    part: EdgePartition,
    block_size: int,
    *,
    vblock_multiple: int = 8,
    vblock_size: int | None = None,
) -> BlockSet:
    """Packs a shard's edges into fixed-size blocks.

    Edges are taken in order (the partitioner already groups them by src,
    mirroring "select a vertex and retrieve its outer edges"), so
    consecutive edges share sources and vertex blocks stay small.
    """
    e = part.num_edges
    b = int(block_size)
    nb = max(1, -(-e // b))
    pad_e = nb * b - e

    src = np.concatenate([part.src, np.zeros(pad_e, dtype=np.int32)])
    dst = np.concatenate([part.dst, np.zeros(pad_e, dtype=np.int32)])
    if part.weights is not None:
        w = np.concatenate([part.weights, np.zeros(pad_e, dtype=np.float32)])
    else:
        w = np.ones(e + pad_e, dtype=np.float32)
    emask = np.concatenate([np.ones(e, dtype=bool), np.zeros(pad_e, dtype=bool)])

    src = src.reshape(nb, b)
    dst = dst.reshape(nb, b)
    w = w.reshape(nb, b, 1)
    emask = emask.reshape(nb, b)

    # Per-block vertex blocks + local indices.
    uniques: list[np.ndarray] = []
    lsrcs = np.zeros((nb, b), dtype=np.int32)
    ldsts = np.zeros((nb, b), dtype=np.int32)
    max_u = 0
    for i in range(nb):
        both = np.concatenate([src[i], dst[i]])
        uniq, inv = np.unique(both, return_inverse=True)
        uniques.append(uniq.astype(np.int32))
        lsrcs[i] = inv[:b]
        ldsts[i] = inv[b:]
        max_u = max(max_u, uniq.shape[0])

    vb = _round_up(max_u, vblock_multiple)
    if vblock_size is not None:
        if vblock_size < max_u:
            raise ValueError(f"vblock_size {vblock_size} < max unique {max_u}")
        vb = vblock_size
    vids = np.zeros((nb, vb), dtype=np.int32)
    vmask = np.zeros((nb, vb), dtype=bool)
    for i, uniq in enumerate(uniques):
        vids[i, : uniq.shape[0]] = uniq
        vmask[i, : uniq.shape[0]] = True

    return BlockSet(
        block_size=b,
        vblock_size=vb,
        num_blocks=nb,
        num_edges=e,
        vids=vids,
        vmask=vmask,
        lsrc=lsrcs,
        ldst=ldsts,
        weights=w,
        emask=emask,
        gsrc=src,
        gdst=dst,
    )


def widen_vblocks(bs: BlockSet, vblock_size: int) -> BlockSet:
    """``bs`` with its vertex blocks padded to ``vblock_size`` slots — the
    arrays :func:`build_blocks` gives at that width, since the width only
    pads ``vids`` / ``vmask``.  The edge arrays are shared with ``bs``, and
    ``bs`` itself is returned when it already has the width."""
    pad = int(vblock_size) - bs.vblock_size
    if pad < 0:
        raise ValueError(f"cannot narrow vertex blocks of {bs.vblock_size} "
                         f"to {vblock_size}")
    if pad == 0:
        return bs
    return dataclasses.replace(
        bs, vblock_size=int(vblock_size),
        vids=np.pad(bs.vids, ((0, 0), (0, pad))),
        vmask=np.pad(bs.vmask, ((0, 0), (0, pad))))
