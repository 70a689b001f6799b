"""Upper systems (the distributed side of the middleware, DESIGN.md §2), as
in the JAX package's ``plug/uppers.py``.

* ``HostUpperSystem`` — the single-host upper system: partitioning, the
  lazy exchange plan, and the cross-shard merge as a fold over the
  per-shard host arrays.  It stays on the host by design: the host drive
  loop's aggregates are host arrays.

* ``MeshUpperSystem`` — the merge as a reduction over a leading shard
  axis: ``merge`` for the host loop's per-shard arrays, and
  ``merge_partials`` for the fused loop's device-resident (m, N, K)
  partials, which stay where the daemon left them, and
  ``merge_partials_async``, the fused async loop's commit half.  The axis
  spans m logical devices on the one card (``protocols.divisor_mesh``),
  and ``remesh`` / ``migrate`` (``protocols.ElasticUpper``) move a live
  run onto another m.  ``wire="compressed"`` sends the host loop's summed
  aggregate through ``dist.collectives``' int8 error-feedback all-reduce
  over the m logical devices.  Over a
  :class:`~repro_torch.dist.sharding.RankMesh` the axis spans W ranks of
  ``local`` logical devices each: a rank folds its own devices, then one
  ``all_reduce`` (MIN or MAX for an idempotent monoid, SUM otherwise)
  merges the ranks, and the compressed wire is a real collective.  A
  survivor RankMesh re-targets the merge at its group (``remesh``), and a
  rank that joins gets the run's tensors by ``broadcast`` (``migrate``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.sync import lazy_exchange_plan
from repro_torch.core.template import VertexProgram
from repro_torch.dist.collectives import make_compressed_allreduce
from repro_torch.dist.sharding import LOCAL_MESH, RankMesh
from repro_torch.graph.partition import partition_contiguous
from repro_torch.graph.structure import Graph
from repro_torch.plug.protocols import divisor_mesh


def _rank_op(monoid) -> str:
    """The ``all_reduce`` op that merges ``monoid`` across ranks."""
    if not monoid.idempotent:
        return "sum"
    op = {torch.minimum: "min", torch.maximum: "max"}.get(monoid.combine)
    if op is None:
        raise ValueError(f"monoid {monoid.name!r} has no all_reduce op")
    return op


class HostUpperSystem:
    """Host-side merge over per-shard arrays."""

    name = "host"

    def partition(self, graph: Graph, num_shards: int, fractions=None):
        """Contiguous edge ranges; ``fractions`` (e.g. from
        ``core.balance.lemma2_fractions``) sizes shards capacity-aware."""
        return partition_contiguous(graph, num_shards, fractions)

    def bind(self, program: VertexProgram, num_shards: int, *,
             device=None):
        self.program = program
        self.monoid = program.monoid
        self.num_shards = num_shards
        return self

    def reset(self):
        """Called at the start of every ``Middleware.run`` — clears any
        per-run state so repeated runs are reproducible."""

    def exchange(self, updated_boundary, queried):
        return lazy_exchange_plan(updated_boundary, queried)

    def _fold(self, arrays) -> np.ndarray:
        return functools.reduce(
            self.monoid.combine,
            [torch.from_numpy(np.asarray(a)) for a in arrays]).numpy()

    def merge(self, states, aggs, cnts):
        if self.monoid.idempotent:
            # States may have diverged across skipped rounds; the
            # idempotent combine over replicas restores consistency.
            base = self._fold(states)
            agg = self._fold(aggs)
        else:
            base = np.asarray(states[0])
            agg = functools.reduce(np.add, [np.asarray(a) for a in aggs])
        cnt = np.sum(np.stack(cnts), axis=0)
        return base, agg, cnt

    def resolve(self, states):
        if len(states) == 1 or not self.monoid.idempotent:
            return states[0]
        return self._fold(states)


class MeshUpperSystem(HostUpperSystem):
    """The global merge as a reduction over a leading shard axis.

    Shard arrays are stacked on axis 0 and folded with the monoid, as the
    JAX package's ``shard_map`` merge folds each device's shards before its
    ``pmin``/``pmax``/``psum``: each of the ``m`` logical devices
    (:func:`~repro_torch.plug.protocols.divisor_mesh`) folds its S/m
    contiguous shards, then the m results fold in group order.  Every fold
    happens on the device the partials lie on.

    Over a :class:`~repro_torch.dist.sharding.RankMesh` (m = W·local) a rank
    holds only its own shards' arrays: its ``local`` devices fold in group
    order, and the ranks' results merge with one ``all_reduce`` of the
    aggregate (MIN / MAX / SUM) and one SUM of the counts,
    so every rank holds the same bytes.  ``wire_stats`` count what the
    JAX package counts at the same m.

    ``wire="exact"`` (the default) keeps the merge lossless.
    ``wire="compressed"`` carries a sum monoid's aggregate over the int8
    (``bits``-bit) error-feedback all-reduce of ``dist.collectives``: the
    per-shard aggregates fold into per-device partials on the device
    ``bind`` was given (the middleware's), the wire returns their mean, and
    the sum is the mean times m.  The error-feedback residual is per-run
    state, cleared by ``reset``; the compressed wire runs on the host loop
    only (``merge_partials`` and ``merge_partials_async`` refuse it, as
    the JAX package's do).
    """

    name = "mesh"
    WIRES = ("exact", "compressed")

    def __init__(self, mesh=None, *, axis: str = "shard",
                 wire: str = "exact", bits: int = 8):
        if wire not in self.WIRES:
            raise ValueError(f"wire must be one of {self.WIRES}, got {wire!r}")
        self.mesh = mesh
        self.axis = axis
        self.wire = wire
        self.bits = bits
        self.m = 0
        self.local = 0  # logical devices this process folds
        self.ranks = mesh if isinstance(mesh, RankMesh) else LOCAL_MESH
        self.joined = ()  # ranks the last re-mesh added (migrate's)
        self.source = 0  # the rank that broadcasts to them
        self._op = None  # the all_reduce op of the monoid across ranks
        self.device = torch.device("cpu")
        self._allreduce = None
        self._residual = None
        self.wire_stats = {"exact_bytes": 0, "compressed_bytes": 0}

    def bind(self, program: VertexProgram, num_shards: int, *,
             device=None):
        super().bind(program, num_shards)
        if device is not None:
            self.device = torch.device(device)
        # a rebind (another shard count, a remesh) must not keep the wire
        # or the residual built for the previous layout
        self._allreduce = None
        self._residual = None
        if self.wire == "compressed" and program.monoid.idempotent:
            raise ValueError(
                "wire='compressed' quantizes a summed aggregate; idempotent "
                "(min/max) merges must use wire='exact'")
        self.m = divisor_mesh(num_shards, self.mesh)
        if isinstance(self.mesh, RankMesh):
            self.ranks, self.local = self.mesh, self.mesh.local
            self._op = _rank_op(program.monoid)
        else:
            self.ranks, self.mesh, self.local = LOCAL_MESH, self.m, self.m
        if self.wire == "compressed":
            self._allreduce = make_compressed_allreduce(
                self.mesh, self.axis, bits=self.bits)
        return self

    def remesh(self, mesh):
        """Re-targets the merge at a survivor shard axis of ``mesh`` logical
        devices — checkpoint-free migration's upper half.  The only caller
        is the middleware's structure-epoch ``"upper"`` hook: triggers
        publish an epoch, the hooks rebuild, and the drive loops adopt the
        result when they see the version move.  The new axis is validated
        (an int that divides the bound shard count, or over ranks a
        survivor :class:`~repro_torch.dist.sharding.RankMesh` whose m
        divides it) before anything changes; then the rebind re-derives m.
        A new RankMesh re-targets the merge at its group; the ranks it adds
        are noted for :meth:`migrate`."""
        if isinstance(self.ranks, RankMesh) != isinstance(mesh, RankMesh):
            raise ValueError(f"a merge across ranks re-meshes onto a "
                             f"RankMesh, one process onto an int; got "
                             f"{mesh!r}")
        divisor_mesh(self.num_shards, mesh)
        if isinstance(mesh, RankMesh) and mesh is not self.ranks:
            kept = [r for r in self.ranks.members if r in mesh.members]
            if not kept:
                raise ValueError(f"no rank of {list(self.ranks.members)} "
                                 f"survives into {list(mesh.members)}")
            self.joined = tuple(r for r in mesh.members
                                if r not in self.ranks.members)
            self.source = kept[0]
        self.mesh = mesh
        return self.bind(self.program, self.num_shards)

    def migrate(self, tree):
        """Places ``tree`` (a tuple or list of tensors, or one tensor) on
        the re-meshed device set.  Every logical device of the one card
        already reads the same tensors, and so does every survivor rank:
        they are returned unchanged, with no copy and no host round trip.
        A rank that joined at the last re-mesh gets them by a
        ``broadcast`` from ``source``, the lowest rank kept from the
        previous group; it passes tensors of the same shapes to be
        overwritten.  An idle rank gets its tensors back untouched."""
        if not self.joined or self.ranks.idle:
            return tree
        for t in ([tree] if isinstance(tree, torch.Tensor) else tree):
            if t is not None:  # a bool tensor travels as its bytes
                self.ranks.broadcast(t.view(torch.uint8)
                                     if t.dtype == torch.bool else t,
                                     self.source)
        return tree

    def reset(self):
        # per-run state: the error-feedback residual and the wire counters
        # restart with every run; a run places its carry on every rank
        self._residual = None
        self.joined = ()
        self.wire_stats = {"exact_bytes": 0, "compressed_bytes": 0}

    def _fold_axis(self, stack: torch.Tensor) -> torch.Tensor:
        """Folds a stacked (S, ...) tensor over axis 0 in shard order: the
        monoid's combine, or + for a sum."""
        op = self.monoid.combine if self.monoid.idempotent else torch.add
        return functools.reduce(op, stack.unbind(0))

    def _fold_groups(self, stack: torch.Tensor) -> torch.Tensor:
        """Folds a stacked (S, ...) tensor as this process's devices do:
        each device's contiguous shards, then the results in order."""
        groups = stack.reshape(self.local, -1, *stack.shape[1:])
        return self._fold_axis(torch.stack([self._fold_axis(g)
                                            for g in groups.unbind(0)]))

    def merge(self, states, aggs, cnts):
        """The classic path's merge of per-shard host arrays (over a
        RankMesh, this rank's shards') → ``(base, agg, cnt)`` host arrays.
        Idempotent monoids fold the replicas' states and the aggregates
        with ``combine``; a sum takes state 0 as the base (its replicas
        never diverge) and adds the aggregates; counts add."""
        st, ag, cn = (torch.from_numpy(np.stack([np.asarray(a) for a in x]))
                      for x in (states, aggs, cnts))
        reduce = self.ranks.all_reduce_host
        base = (reduce(self._fold_groups(st).numpy(), self._op)
                if self.monoid.idempotent else st[0].numpy())
        cnt = reduce(cn.sum(0, dtype=torch.int32).numpy(), "sum")
        nbytes = st[0].numel() * 4
        if self.wire == "compressed":
            agg = self._compressed_sum(ag)
            self.wire_stats["compressed_bytes"] += (
                (nbytes * self.bits) // 32 + 4) * self.m
        else:
            agg = reduce(self._fold_groups(ag).numpy(), self._op)
            self.wire_stats["exact_bytes"] += nbytes * self.m
        return base, agg, cnt

    def resolve(self, states):
        # a sum's replicas never diverge; an idempotent fold spans the ranks
        final = super().resolve(states)
        return (self.ranks.all_reduce_host(final, self._op)
                if self.monoid.idempotent else final)

    def _compressed_sum(self, aggs: torch.Tensor) -> np.ndarray:
        """A sum monoid's aggregate over the int8 error-feedback wire: the
        (S, N, K) per-shard aggregates (this rank's, over a RankMesh) fold,
        on the bound device, into this process's device partials (each its
        contiguous shards in order); the all-reduce hands every device the
        mean of the m partials, and the sum is that mean times m."""
        stack = aggs.to(self.device, torch.float32)
        parts = torch.stack([self._fold_axis(g) for g in stack.reshape(
            self.local, -1, *stack.shape[1:]).unbind(0)])
        if self._residual is None:
            self._residual = torch.zeros_like(parts)
        means, self._residual = self._allreduce(parts, self._residual)
        return (means[0] * self.m).cpu().numpy()

    def merge_partials(self, partials: torch.Tensor, counts: torch.Tensor):
        """Reduces this process's per-device partials (local, N, K) /
        counts (local, N) over axis 0 in group order → ``(agg (N, K), cnt
        (N,) int32)`` on their device: min or max for an idempotent monoid,
        a sum otherwise; then one ``all_reduce`` of each across the ranks
        (none on one process).  The compressed wire's residual is per-run
        host-loop state, so it is refused here."""
        if self.wire != "exact":
            raise ValueError("merge_partials supports wire='exact' only; "
                             "compressed merges take the classic path")
        agg = self._fold_axis(partials).contiguous()
        if agg.untyped_storage().data_ptr() == \
                partials.untyped_storage().data_ptr():
            # one device's partial is a view of the caller's tensor, which
            # the in-place all_reduce must not overwrite (the async loop
            # keeps it as its held copy)
            agg = agg.clone()
        agg = self.ranks.all_reduce(agg, self._op)
        cnt = self.ranks.all_reduce(counts.sum(0, dtype=torch.int32), "sum")
        return agg, cnt

    def merge_partials_async(self, fresh_p, fresh_c, held_p, held_c,
                             theta, floor, run_mask=None):
        """The async merge cadence, the fused async loop's commit half.

        Decides per device whether this round's merge consumes its fresh
        partial or the held one it last shipped:

        1. fresh partials are set to the monoid identity wherever the
           device delivered no message;
        2. a device's priority is how far its fresh contribution moved
           from its held copy (L∞ over values and counts); NaN distances
           (a non-finite identity minus itself) count 0, and ±inf clamps
           to float32 max, so the priority stays finite;
        3. devices at or above ``theta`` refresh — all of them once
           ``theta`` is at or below ``floor`` — and the rest hold;
        4. the chosen partials reduce through :meth:`merge_partials`.

        ``run_mask`` (m,) bool on the partials' device is the predict
        half's verdict: a held device ran no Gen, so its fresh row is not
        a real aggregate and it cannot refresh this round.  For
        idempotent monoids that row may carry a priority bucket's
        partial, folded into the held copy with ``monoid.combine`` (a
        no-op where it is the identity); a sum carries the held copy
        verbatim.

        ``theta`` is a float32 scalar tensor.  Returns ``(agg, cnt,
        held_p, held_c, refreshed, pri)``: the merged aggregate and
        counts, the next held copies, the (m,) bool refresh mask and the
        (m,) f32 priorities.
        """
        if self.wire != "exact":
            raise ValueError("merge_partials_async supports wire='exact' "
                             "only; compressed merges take the classic path")
        monoid = self.monoid
        ident = torch.full_like(fresh_p, monoid.identity)
        fresh_p = torch.where((fresh_c > 0)[..., None], fresh_p, ident)
        diff = torch.nan_to_num((fresh_p - held_p).abs(), nan=0.0)
        pri = torch.maximum(
            diff.amax(dim=(1, 2)),
            (fresh_c - held_c).abs().to(torch.float32).amax(dim=1))
        if run_mask is None:
            run_mask = torch.ones_like(pri, dtype=torch.bool)
        theta = torch.as_tensor(theta, dtype=torch.float32, device=pri.device)
        # floor as its float32 value, the threshold's own type
        refreshed = (((pri >= theta) | (theta <= float(np.float32(floor))))
                     & run_mask)
        if monoid.idempotent:
            # fold held devices' bucket partials into the held copy
            bucket_p = torch.where(run_mask[:, None, None], ident, fresh_p)
            bucket_c = torch.where(run_mask[:, None],
                                   torch.zeros_like(fresh_c), fresh_c)
            hold_p = monoid.combine(held_p, bucket_p)
            hold_c = torch.maximum(held_c, bucket_c)
        else:
            # a sum tolerates no duplicate: the held copy stays as it was
            hold_p, hold_c = held_p, held_c
        held_p = torch.where(refreshed[:, None, None], fresh_p, hold_p)
        held_c = torch.where(refreshed[:, None], fresh_c, hold_c)
        agg, cnt = self.merge_partials(held_p, held_c)
        return agg, cnt, held_p, held_c, refreshed, pri


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_UPPERS: dict = {}


def register_upper_system(name: str, factory) -> None:
    _UPPERS[name] = factory


def get_upper_system(name: str, **kwargs):
    try:
        factory = _UPPERS[name]
    except KeyError:
        raise KeyError(f"unknown upper system {name!r}; registered: "
                       f"{sorted(_UPPERS)}") from None
    return factory(**kwargs)


def upper_system_names() -> tuple:
    return tuple(sorted(_UPPERS))


register_upper_system("host", HostUpperSystem)
register_upper_system("mesh", MeshUpperSystem)
