"""The GX-Plug algorithm template (paper Sec. IV-A), in PyTorch.

A graph algorithm is expressed through three APIs:

  * ``msg_gen``   (MSGGen)   — per-edge message generation from the edge
                               triplet (src state, dst state, edge weight).
  * ``msg_merge`` (MSGMerge) — a *monoid* combining messages destined to the
                               same vertex (min / max / sum / or).
  * ``msg_apply`` (MSGApply) — per-vertex state update from the merged
                               message; also reports per-vertex activity
                               (the frontier).

State layout as in the JAX package: vertex state is a dense ``(N, K)``
float32 tensor, messages ``(E, K)``, static per-vertex features ``(N, A)``.

The CUDA kernels cannot call a Python ``msg_gen``, so a program also names
its message function from the fixed table :data:`GEN_OPS` (``gen_op``); the
kernels compile each entry in as a template parameter.  ``msg_gen`` stays the
plain definition the CPU path and the tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

#: Message functions the CUDA kernels implement, by name → the integer the
#: kernels switch on (``kernels/csrc/common.cuh``, ``enum GenOp``).
#: ``s`` is the src state row, ``w`` the edge weight, ``a0`` the src aux
#: column 0.
GEN_OPS = {
    "pr_div_deg": 0,   # s / max(a0, 1)      (pagerank)
    "add_weight": 1,   # s + w               (sssp_bf)
    "mul_weight": 2,   # s * w               (label_prop)
    "copy_src": 3,     # s                   (wcc)
    "add_one": 4,      # s + 1               (bfs)
}

# The reduce name ``Tensor.scatter_reduce_`` takes per monoid.  "or"
# operates on {0.0, 1.0} indicators, where logical-or is exactly max.
_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "or": "amax"}


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative, associative merge with identity (MSGMerge semantics)."""

    name: str
    identity: float
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # Idempotent monoids (min/max/or) tolerate stale re-delivery and
    # duplicated contributions; only they are eligible for sync skipping.
    idempotent: bool

    def _reduce_name(self) -> str:
        try:
            return _SCATTER_REDUCE[self.name]
        except KeyError:
            raise ValueError(
                f"monoid {self.name!r} has no scatter rule; known: "
                f"{sorted(_SCATTER_REDUCE)}") from None

    def segment_reduce(self, msgs: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """``out[s] = combine over msgs[seg_ids == s]``; empty segments
        read the identity (the JAX package fills them with ±inf and masks
        them to the identity afterwards — the same values where read)."""
        reduce = self._reduce_name()
        out = torch.full((num_segments,) + tuple(msgs.shape[1:]),
                         self.identity, dtype=msgs.dtype, device=msgs.device)
        idx = seg_ids.long()
        if msgs.dim() > 1:
            idx = idx.view(-1, *([1] * (msgs.dim() - 1))).expand_as(msgs)
        return out.scatter_reduce_(0, idx, msgs, reduce=reduce,
                                   include_self=True)

    def scatter_at(self, out: torch.Tensor, ids, vals) -> None:
        """In-place scatter-combine: ``out[ids] = combine(out[ids], vals)``.

        The streaming daemon's upload merges block partials into the host
        aggregate with this; a monoid with no known rule raises rather than
        merging with the wrong operator.
        """
        reduce = self._reduce_name()
        ids = torch.as_tensor(ids, device=out.device).long().reshape(-1)
        vals = torch.as_tensor(vals, device=out.device).reshape(
            (ids.numel(),) + tuple(out.shape[1:]))
        idx = ids.view(-1, *([1] * (out.dim() - 1))).expand_as(vals)
        out.scatter_reduce_(0, idx, vals.to(out.dtype), reduce=reduce,
                            include_self=True)


SUM = Monoid("sum", 0.0, torch.add, idempotent=False)
MIN = Monoid("min", float(np.finfo(np.float32).max), torch.minimum,
             idempotent=True)
MAX = Monoid("max", float(np.finfo(np.float32).min), torch.maximum,
             idempotent=True)
#: Logical OR over {0.0, 1.0} indicator messages, implemented as max.
OR = Monoid("or", 0.0, torch.maximum, idempotent=True)

MONOIDS = {m.name: m for m in (SUM, MIN, MAX, OR)}


def segment_sum(vals: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Integer/float segment sum (``jax.ops.segment_sum``)."""
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids.long(), vals)


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """An algorithm instance of the template.

    ``msg_gen``/``msg_apply`` are torch functions vectorized over the
    leading (edge or vertex) axis.  ``gen_op`` names the same message
    function in :data:`GEN_OPS` for the CUDA kernels; a program without
    one runs on the plain path only, and the CUDA path raises for it.
    """

    name: str
    state_width: int  # K
    aux_width: int  # A (0 allowed)
    monoid: Monoid
    # msg_gen(src_state (E,K), dst_state (E,K), weight (E,1), src_aux (E,A)) -> (E,K)
    msg_gen: Callable[..., torch.Tensor]
    # msg_apply(state (N,K), merged (N,K), has_msg (N,1) bool, aux (N,A), t) -> (state', active (N,))
    msg_apply: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    # init(graph) -> (state (N,K) np.float32, aux (N,A) np.float32)
    init: Callable[..., tuple[np.ndarray, np.ndarray]]
    max_iterations: int = 100
    # Only edges whose src was active last iteration generate messages.
    frontier_driven: bool = True
    gen_op: str | None = None
    # -- batched multi-query programs (repro_torch.serve) ------------------
    # B > 0 declares the state a stack of B independent queries, each
    # owning K/B consecutive state columns.  ``query_activity(old, new) ->
    # (N, B) bool`` reports which vertices changed per query; the apply
    # step then freezes converged queries by reverting their columns
    # (``plug.middleware.apply_step``), so a finished query stops feeding
    # the shared frontier while its batch-mates keep running.
    num_queries: int = 0
    query_activity: Callable[..., torch.Tensor] | None = None

    def supports_sync_skipping(self) -> bool:
        return self.monoid.idempotent

    def is_batched_query(self) -> bool:
        """True iff this program declares the per-query convergence
        contract (``plug.protocols.BatchQueryCapable``)."""
        return self.num_queries > 0 and self.query_activity is not None
