"""Public wrappers around the port's kernels (the JAX package's
``kernels/ops.py``).  What the JAX package keeps outside Pallas is plain
PyTorch here too: the vertex-table gathers before a graph kernel and the
cross-tile combine after it, and the SSD's cross-chunk recurrence.  The
kernel bodies are the CUDA kernels of ``kernels/edge_block.py``,
``kernels/flash_attention.py`` and ``kernels/ssd_scan.py`` (their plain
versions on CPU tensors).  ``impl="cuda"`` takes the place of the JAX
package's ``impl="pallas"``; ``impl="reference"`` runs the oracles of
``kernels/ref.py``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.edge_block import csr_tile, csr_tile_plain, edge_block
from repro_torch.kernels.ssd_scan import ssd_chunk


@dataclasses.dataclass(frozen=True)
class CSRConfig:
    """How the CSR aggregation cuts a shard into tiles (the tile fields of
    the JAX package's ``kernels/autotune.CSRConfig``; its lowering, merge
    and gather choices and the sweep that picks among them,
    ``autotune_csr``, are ROADMAP Queue A item 5).

    Attributes:
      edge_tile: edges per tile (ET); also the hub threshold unless
        ``hub_threshold`` overrides it.
    """

    edge_tile: int = 512
    hub_threshold: int | None = None


def _check_impl(impl: str) -> None:
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'reference', got {impl!r}")


def _pad_aux(state, aux):
    # zero-width aux: the kernels take an aux column to keep one signature
    if aux.shape[1] == 0:
        return torch.zeros((state.shape[0], 1), dtype=state.dtype,
                           device=state.device)
    return aux


# --------------------------------------------------------------------------
# edge block
# --------------------------------------------------------------------------
def edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask, *,
                         program: VertexProgram, impl: str = "cuda"):
    """Agent-side wrapper: gathers the paired vertex blocks, then runs the
    edge-block kernel over all blocks (``impl="reference"``: the oracle)."""
    if impl == "reference":
        return ref.edge_block_aggregate(state, aux, vids, lsrc, ldst, w,
                                        emask, program=program)
    _check_impl(impl)
    aux = _pad_aux(state, aux)
    vids = vids.long()
    return edge_block(state[vids], aux[vids], lsrc, ldst,
                      w.to(torch.float32), emask.to(torch.float32),
                      program=program)


# --------------------------------------------------------------------------
# CSR tile aggregation
# --------------------------------------------------------------------------
#: The plain per-tile twin of the CSR-tile kernel (``_csr_tiles_xla`` in the
#: JAX package); ``csr_tile`` runs it on CPU tensors.
_csr_tiles_plain = csr_tile_plain


def csr_aggregate(state, aux, csr: dict, *, program: VertexProgram,
                  num_vertices: int, config: CSRConfig):
    """Fused gather + Gen + segmented Merge over CSR tiles → (N, K) agg.

    Args:
      state (N, K) f32, aux (N, A) f32 — the shard vertex table.
      csr: dict of per-tile tensors with leading tile axis T (the
        ``CSRTileSet.arrays()`` layout): rows (T, RT), seg/lsrc/gsrc/gdst
        (T, ET), svids (T, ST), w (T, ET, 1), emask (T, ET) bool.
        ``emask`` may already carry per-edge frontier filtering.
      config: a :class:`CSRConfig` (the tiles were cut with it).
    Returns:
      agg (N, K) f32 — merged messages; vertices with no message read the
      monoid identity.  cnt (N,) i32 — messages per vertex.
    """
    monoid = program.monoid
    k = program.state_width
    n = num_vertices
    aux = _pad_aux(state, aux)
    svids = csr["svids"].long()
    rows = csr["rows"].long()
    vsrc = state[svids]            # (T, ST, K) compact src blocks
    vaux = aux[svids]
    # (T, RT, K) compact row blocks: only the plain version's msg_gen is
    # handed them; the kernel's message functions never read dst state,
    # so on the card a broadcast view gives csr_tile their shape alone
    rowst = (state[rows] if state.device.type == "cpu"
             else state.new_zeros(()).expand(*rows.shape, k))
    partial, counts = csr_tile(vsrc, vaux, rowst, csr["lsrc"], csr["seg"],
                               csr["w"].to(torch.float32),
                               csr["emask"].to(torch.float32),
                               program=program)
    # cross-tile combine: finishes split hub rows and folds every tile's
    # row partials into the shard aggregate
    rows = rows.reshape(-1)
    agg = monoid.segment_reduce(partial.reshape(-1, k), rows, n)
    cnt = segment_sum(counts.reshape(-1), rows, n)
    agg = torch.where((cnt > 0)[:, None], agg,
                      torch.full_like(agg, monoid.identity))
    return agg, cnt


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, impl: str = "cuda",
                    block_q: int = 128, block_k: int = 128):
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) → (B, Hq, S, D) in q's dtype.

    ``block_q``/``block_k`` are checked as the JAX kernel checks them (S
    must divide into ``min(block, S)`` blocks), so the same calls are
    refused; the CUDA kernel tiles by its own 64 rows and its result does
    not depend on them."""
    if impl == "reference":
        return ref.flash_attention(q, k, v, causal=causal)
    _check_impl(impl)
    if q.dim() == 4:
        s = q.shape[2]
        for name, blk in (("block_q", block_q), ("block_k", block_k)):
            if blk < 1 or s % min(blk, s) != 0:
                raise ValueError(f"S={s} must divide into {name}={blk} "
                                 "blocks")
    return fa.flash_attention(q, k, v, causal=causal)


# --------------------------------------------------------------------------
# SSD scan (Mamba2)
# --------------------------------------------------------------------------
def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 64, impl: str = "cuda"):
    """Full SSD: within-chunk kernel + cross-chunk recurrence.

    x (B, S, H, P), dt (B, S, H), a (H,), b_mat/c_mat (B, S, G, N) with
    H % G == 0.  Returns y (B, S, H, P) in x's dtype.  The kernel reads B
    and C by group; only the (B, NC, L, G, N) views of them are formed.
    """
    if impl == "reference":
        return ref.ssd_scan_chunked_ref(x, dt, a, b_mat, c_mat, chunk=chunk)
    _check_impl(impl)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    ref.check_chunk(s, chunk)
    nc = s // chunk

    def chunks(t):
        return t.float().contiguous().reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = map(chunks, (x, dt, b_mat, c_mat))
    y_local, states, decays, gates = ssd_chunk(
        xc, dtc, a.float().contiguous(), bc, cc)

    # Cross-chunk recurrence (the agent-side combine): the state carried
    # into each chunk.
    carry_in = torch.empty_like(states)  # (B, NC, H, N, P)
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    for c in range(nc):
        carry_in[:, c] = hstate
        hstate = hstate * decays[:, c, :, None, None] + states[:, c]

    # y_carry[t] = gate_t · C_t · carry_in, with C read by group
    r = h // g
    y_carry = torch.einsum(
        "bclgn,bcgrnp->bclgrp", cc, carry_in.reshape(bsz, nc, g, r, n, p))
    y_carry = y_carry * gates.reshape(bsz, nc, chunk, g, r)[..., None]
    y = (y_local + y_carry.reshape(bsz, nc, chunk, h, p)).reshape(bsz, s, h, p)
    return y.to(x.dtype)
