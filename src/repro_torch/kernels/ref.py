"""Plain PyTorch oracle for the edge-block daemon program (the JAX
package's ``kernels/ref.py::edge_block_aggregate``)."""
from __future__ import annotations

from repro_torch.core.template import VertexProgram
from repro_torch.kernels.edge_block import edge_block_plain


def edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask, *,
                         program: VertexProgram):
    """Per-block Gen + block-local Merge over the vertex table.

    Args:
      state (N, K) f32, aux (N, A) f32 — the shard vertex table.
      vids  (nb, VB) i32 — vertex blocks (global ids).
      lsrc, ldst (nb, B) i32 — block-local edge endpoints.
      w (nb, B, 1) f32, emask (nb, B) bool.
    Returns:
      partial (nb, VB, K) f32 — per-block merged messages (monoid), the
      identity at message-free slots.
      counts  (nb, VB) i32    — messages received per vertex slot.
    """
    vids = vids.long()
    return edge_block_plain(state[vids], aux[vids], lsrc, ldst, w,
                            emask.float(), program=program)
