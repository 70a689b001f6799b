"""Agent-side wrappers around the two graph kernels (the JAX package's
``kernels/ops.py``): the vertex-table gathers before a kernel and the
cross-tile combine after it are plain PyTorch, as the JAX package keeps
them outside Pallas; the tile and block bodies are the CUDA kernels of
``kernels/edge_block.py`` (their plain versions on CPU tensors)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.kernels import ref
from repro_torch.kernels.edge_block import csr_tile, csr_tile_plain, edge_block


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
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'reference', got {impl!r}")
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
