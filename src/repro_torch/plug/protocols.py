"""The three plug-in seams of the middleware (DESIGN.md §2), as in the JAX
package's ``plug/protocols.py``:

* :class:`Daemon` — the accelerator backend, bound to one
  :class:`~repro_torch.core.template.VertexProgram` and a torch device, then
  answering ``run_blocks``: the shard's merged (N, K) message aggregate and
  per-vertex message counts for a selection of edge blocks.
* :class:`UpperSystem` — partitioning, the lazy exchange plan and the
  cross-shard global merge.
* :class:`ComputationModel` — the strategy ordering Gen/Merge/Apply.

Two optional capabilities switch the middleware to the device-resident
fused loop: :class:`ShardCapableDaemon` (``run_all_shards`` over every
shard stacked on one leading axis) and :class:`DevicePartialUpper`
(``merge_partials`` of the per-device partials).  Two more select and
speed up the fused async loop: :class:`PriorityAsyncModel` (the model's
priority threshold) and :class:`MaskCapableDaemon` (a hold that skips the
held devices' work).  :class:`ElasticUpper` lets a fused composition
survive a change of the shard axis mid-run (a kill, a join, a
straggler's re-partition).  The out-of-core capability of the JAX package
comes with ROADMAP Queue A item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.blocks import BlockSet
from repro_torch.core.sync import SyncStats
from repro_torch.core.template import VertexProgram
from repro_torch.dist.sharding import RankMesh
from repro_torch.graph.structure import EdgePartition, Graph


@dataclasses.dataclass
class PlugOptions:
    """Options of the middleware itself — component-neutral knobs only."""

    block_size: int | str = "auto"  # edges per block; "auto" → Lemma 1
    sync_caching: bool = True
    sync_skipping: bool = True
    cache_capacity: int = 1 << 14
    frontier_block_skipping: bool = True
    # calibrated Lemma-1 coefficients (entities = edges)
    k1: float = 2e-8
    k2: float = 6e-8
    k3: float = 2e-8
    a: float = 2e-4


@dataclasses.dataclass
class Result:
    """What a middleware run returns."""

    state: np.ndarray  # (N, K) final vertex state
    iterations: int
    converged: bool
    stats: SyncStats
    wall_time: float
    per_iteration: list[dict]


@runtime_checkable
class Daemon(Protocol):
    """Accelerator backend: block programs behind one ``run_blocks``."""

    name: str

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda") -> "Daemon":
        """Prepares the daemon for one program on ``device``; returns self."""
        ...

    def run_blocks(self, state: np.ndarray, aux: np.ndarray,
                   blockset: BlockSet, sel: np.ndarray,
                   record: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Gen + Merge over the selected blocks of one shard.

        Args:
          state, aux: the shard's (N, K) / (N, A) host vertex table.
          blockset: the shard's packed edge blocks.
          sel: int array of block indices to run (frontier-active blocks).
          record: per-iteration dict the daemon may append timings to.
        Returns:
          (agg, cnt): (N, K) monoid-merged messages and (N,) int counts,
          as host arrays.
        """
        ...


@runtime_checkable
class UpperSystem(Protocol):
    """Distributed-system side: partition, exchange, global merge."""

    name: str

    def partition(self, graph: Graph, num_shards: int,
                  fractions: np.ndarray | None = None) -> List[EdgePartition]:
        """Partitions edges into shards; ``fractions`` (summing to 1)
        requests capacity-aware shard sizes (Lemma 2, Sec. III-C)."""
        ...

    def bind(self, program: VertexProgram, num_shards: int, *,
             device=None) -> "UpperSystem":
        """Binds to a program and a shard count; ``device`` is the
        middleware's, where an upper that works on tensors keeps them."""
        ...

    def reset(self) -> None:
        """Called at the start of every run; clears per-run state."""
        ...

    def exchange(self, updated_boundary: List[np.ndarray],
                 queried: List[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Lazy exchange plan: (global query queue, per-shard uploads)."""
        ...

    def merge(self, states: List[np.ndarray], aggs: List[np.ndarray],
              cnts: List[np.ndarray]):
        """Cross-shard merge → (base_state, merged_agg, total_cnt)."""
        ...

    def resolve(self, states: List[np.ndarray]) -> np.ndarray:
        """Final answer from per-shard state replicas."""
        ...


@runtime_checkable
class ShardCapableDaemon(Protocol):
    """Optional daemon capability: run EVERY shard as one device program.

    A daemon that also has these members (``ShardedDaemon`` does) is
    feature-detected by the middleware, which then drives the
    device-resident fused loop: vertex state never round-trips through the
    host, and the daemon hands (m, N, K) per-device partials straight to
    the upper system's ``merge_partials``.  ``mesh`` is the shard axis'
    device count (:func:`divisor_mesh`); ``stacked`` the device tensors
    ``bind_shards`` placed, which the loop threads through every step.
    """

    mesh: object
    stacked: object

    def bind_shards(self, blocksets, *, mesh=None, axis=None):
        """Stacks every shard's block tensors on a leading axis and places
        them on the device once."""
        ...

    def run_all_shards(self, state, aux, active=None, *, stacked=None):
        """All shards' Gen + Merge + per-device combine on device tensors
        → ``(partials (m, N, K), counts (m, N), blocks_run (S,))``;
        ``active`` is the (N,) frontier shared by every device, an (m, N)
        bool whose row g is device g's private frontier (the fused async
        loop's backlog), or None to run every block."""
        ...


@runtime_checkable
class MaskCapableDaemon(Protocol):
    """Optional daemon capability: per-device conditional Gen execution.

    The fused async loop's *predict* half decides, before Gen, which
    devices hold this iteration.  A daemon with this capability
    (``ShardedDaemon`` has it) takes that verdict as ``run_mask`` in
    ``run_all_shards`` and makes the hold **free**: a held device runs no
    gather, Gen or Merge and contributes the monoid identity (zero counts,
    zero blocks run).  For frontier-driven programs a device whose private
    frontier row is empty is skipped the same way; its identity output
    *is* its exact fresh partial.

    ``configure_buckets`` arms the vertex-level priority buckets: with
    ``k > 0`` (idempotent monoids only) a held device still runs the
    out-edges of its top-``k`` residual vertices, capped at ``cap`` edges
    each, so skew inside a shard is exploited while the shard holds.  The
    commit half folds those bucket partials into the held copy with the
    monoid's combine.

    The middleware detects this protocol on top of
    :class:`ShardCapableDaemon`; a daemon without it runs the async loop
    in its run-everything form.
    """

    mesh: object
    stacked: object

    def configure_buckets(self, k: int, cap: int = 32):
        """Enables or disables the priority buckets; returns self."""
        ...

    def run_all_shards(self, state, aux, active=None, *, run_mask=None,
                       residual=None, stacked=None, live_rows=None):
        """As :meth:`ShardCapableDaemon.run_all_shards`, plus ``run_mask``
        — (m,) bool host values, the devices that may run; a False device,
        or one whose row of a per-device ``active`` is empty, skips its
        shard body (identity partials, zero counts and blocks) —
        ``residual`` — the (N,) f32 per-vertex last state change, the
        buckets' score (unused when they are off) — and ``live_rows`` —
        (m,) host bools, which rows of ``active`` hold a source, when the
        caller already has them."""
        ...


@runtime_checkable
class OutOfCoreCapable(Protocol):
    """Optional daemon capability: graphs bigger than the device budget.

    An out-of-core daemon keeps its column stacks (padded blocks or CSR
    tiles) in host memory, keeps an access-frequency-ordered hot prefix on
    the device, and serves the cold remainder as equal *super-shards*
    copied onto the device on demand.  The middleware detects this
    protocol when ``Middleware(oocore=...)`` is passed and drives the
    out-of-core loop, which accumulates ``run_all_shards`` partials across
    super-shards with the program's monoid before the single upper-system
    merge — bit-identical to the all-resident fused path for idempotent
    monoids.
    """

    num_super_shards: int
    hot_stacked: object      # the resident hot set's stack, or None
    oocore_plan: object      # OocorePlan of the current binding
    super_shard_nbytes: int  # host bytes of one cold super-shard

    def bind_super_shards(self, blocksets, *, mesh=None, axis=None,
                          config=None):
        """Cuts the shards' column stacks into a hot set and host
        super-shards."""
        ...

    def upload_super_shard(self, index: int, out=None, copy: bool = True):
        """Copies cold super-shard ``index`` to the device on the current
        stream (into ``out`` when given; only allocates when ``copy`` is
        False); returns a stacked dict ``run_all_shards(stacked=...)``
        takes."""
        ...

    def super_shard_activity(self, active):
        """(N,) bool frontier on the device → (num_super_shards,) bool on
        the device: which cold groups hold an active live source."""
        ...


@runtime_checkable
class DevicePartialUpper(Protocol):
    """Optional upper-system capability: merge device-resident partials.

    ``merge_partials`` takes the (m, N, K) / (m, N) per-device partials a
    shard-capable daemon produced, where they lie, and reduces them over
    the leading axis to ``(agg (N, K), cnt (N,))`` on the same device.
    The middleware hands the upper's ``mesh`` / ``axis`` to the daemon's
    ``bind_shards`` so both halves of the fused step share one layout.
    """

    mesh: object
    axis: str

    def merge_partials(self, partials, counts):
        ...


def divisor_mesh(num_items: int, mesh=None) -> int:
    """The shard axis' device count m: the number of logical devices the
    ``num_items`` stacked shards split into, each owning num_items/m
    contiguous shards.  The sharded daemon and the mesh upper system both
    take their axis from here.

    ``mesh=None`` is 1.  An int m ≥ 1 that divides ``num_items`` gives m
    logical devices on the one card.  A
    :class:`~repro_torch.dist.sharding.RankMesh` gives m = W·local: W ranks,
    each holding ``local`` logical devices (:func:`shard_range` says which
    shards), or a survivor mesh's m′ devices.  An int that does not divide ``num_items`` or is under 1, or a
    RankMesh whose m does not divide it, raises ``ValueError``.  Any other
    mesh raises :func:`not_ported_error`."""
    if num_items < 1:
        raise ValueError(f"need at least one shard, got {num_items}")
    if mesh is None:
        return 1
    if isinstance(mesh, RankMesh):
        mesh.shard_range(num_items)  # m must divide the shards
        return mesh.size
    if isinstance(mesh, bool) or not isinstance(mesh, (int, np.integer)):
        raise not_ported_error(f"mesh={mesh!r} (a shard axis is an int m of "
                               "logical devices on one card or a RankMesh "
                               "across ranks)", 13)
    m = int(mesh)
    if m < 1 or num_items % m:
        raise ValueError(f"mesh={m} logical devices must be >= 1 and divide "
                         f"the {num_items} shards")
    return m


def shard_range(num_items: int, mesh=None) -> range:
    """The shards this process owns on the axis :func:`divisor_mesh`
    validates: all of them on one process, those of the rank's devices on
    a :class:`~repro_torch.dist.sharding.RankMesh` ([r·S/W, (r+1)·S/W) on
    the world's)."""
    divisor_mesh(num_items, mesh)
    if isinstance(mesh, RankMesh):
        return mesh.shard_range(num_items)
    return range(num_items)


@runtime_checkable
class BatchQueryCapable(Protocol):
    """Optional *program* capability: a batch of B independent queries
    stacked into the state columns (``repro_torch.serve``'s contract).

    A :class:`~repro_torch.core.template.VertexProgram` exposing
    ``num_queries > 0`` plus ``query_activity`` declares that its ``(N, K)``
    state is a stack of B queries, each owning ``K/B`` consecutive columns.
    ``query_activity(old, new) -> (N, B)`` bool reports per-query vertex
    activity; the apply step every drive loop shares
    (``plug.middleware.apply_step``) reduces it to a per-query run mask and
    **freezes converged queries by reverting their columns**:

    * a query whose columns went quiet stops contributing to the shared
      frontier — its batch-mates keep iterating, it exits early;
    * freeze-by-revert keeps the contract stateless (no done flags in the
      carries), and for **idempotent monoids** a quiet round is already
      the column's fixed point, so revert == commit and the batched answer
      is bit-identical to B single-query runs (the serving cache relies on
      it: an answer does not depend on the batch it rode in);
    * for tolerance-converged sum-monoid programs (personalized PageRank)
      the revert drops a sub-tolerance apply — answers lie within a few
      ``tol`` of an unmasked run, and equal across batch compositions up
      to the summation order of the merge.

    The mask, the run flags and the masked frontier stay tensors where the
    state lies: the freeze adds no device→host transfer to any loop.
    """

    num_queries: int

    def query_activity(self, old_state, new_state):
        ...

    def is_batched_query(self) -> bool:
        ...


@runtime_checkable
class ElasticUpper(Protocol):
    """Optional upper-system capability: survive a mid-run mesh change.

    Elastic fault tolerance is checkpoint-free: when a logical device dies
    between fused iterations, the middleware re-plans the shard axis from
    the survivors and *migrates* the live run — stacked block tensors, the
    vertex state and any per-device scheduling carries — onto it.  The
    upper system's half of that contract is this pair:

    * :meth:`remesh` re-targets the merge at a new axis length m′ (an int
      of logical devices on the one card, as
      :func:`divisor_mesh` takes it): m is re-derived and the shard-count
      divisibility checked before anything changes.
      ``MeshUpperSystem`` implements it.
    * :meth:`migrate` moves tensors onto the re-meshed device set.  On one
      card they already lie there, so it returns them unchanged: no copy
      and no host round trip.

    ``Middleware(monitor=...)`` / ``failures=`` require this capability
    (together with :class:`ShardCapableDaemon` + :class:`DevicePartialUpper`
    — i.e. a fused drive loop).
    """

    mesh: object
    axis: str

    def remesh(self, mesh):
        """Re-targets the merge at ``mesh``; returns self."""
        ...

    def migrate(self, tree):
        """Places ``tree`` (tensors, or a list / tuple of them) on the
        current mesh; returns it."""
        ...


# ``gather`` passed to a ComputationModel: calls every shard's daemon and
# returns the per-shard (agg, cnt, read_ids) results for this iteration.
GatherFn = Callable[[dict], Sequence[tuple]]


@runtime_checkable
class PriorityAsyncModel(Protocol):
    """Optional computation-model capability: asynchronous priority
    scheduling (``plug.computation.AsyncModel`` implements it).

    A model with this state — the initial priority threshold, its
    per-iteration decay, and the floor at or below which every producer is
    forced fresh — is detected by the middleware, which (with a
    shard-capable daemon and an exact-wire device-partial upper system
    that also has the ``merge_partials_async`` cadence, as
    ``MeshUpperSystem`` does) runs the fused *async* loop: per-device held
    partials, the frontier backlog and the decaying threshold all live on
    the device (``plug.middleware.AsyncDriveLoop``).  The fused step never
    calls the three hooks, so, as for BSP/GAS fusion, a subclass
    overriding a hook keeps the host loop that drives them.  On any other
    composition the hooks drive the host loop, whose global barrier makes
    every aggregate the freshest available.
    """

    theta0: float
    decay: float
    floor: float

    def prologue(self, gather):
        ...

    def aggregates(self, gather, pending, record):
        ...

    def epilogue(self, gather, record):
        ...


@runtime_checkable
class ComputationModel(Protocol):
    """Orders Gen / Merge / Apply across the superstep boundary."""

    name: str
    order: tuple

    def prologue(self, gather: GatherFn):
        """Runs before the drive loop; returns the initial pending
        aggregates (GAS scatters here) or None (BSP)."""
        ...

    def aggregates(self, gather: GatherFn, pending, record: dict):
        """Returns the aggregates consumed by this iteration's Merge."""
        ...

    def epilogue(self, gather: GatherFn, record: dict):
        """Runs after Apply (non-converged iterations); returns the
        pending aggregates for the next iteration or None."""
        ...


def not_ported_error(what: str, item: int | str) -> NotImplementedError:
    """The error for a component the port does not have yet, naming the
    ROADMAP item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue A item "
        f"{item})")
