"""The middleware: agents + drive loops composed from the three protocols,
as in the JAX package's ``plug/middleware.py``.

``Middleware`` owns what the paper's *agent* role owns — per-shard host
state (vertex table replicas, LRU boundary caches, block sets, byte
accounting) and the iteration drive loop — and delegates device compute to
the :class:`~repro_torch.plug.protocols.Daemon`, partitioning / exchange /
global merge to the :class:`~repro_torch.plug.protocols.UpperSystem`, and
Gen/Merge/Apply ordering to the
:class:`~repro_torch.plug.protocols.ComputationModel`.

Four drive loops implement the iteration:

* :class:`HostDriveLoop` — the classic per-shard path: every iteration
  calls each shard's daemon, brings the aggregates to the host, runs the
  candidate apply for skip detection and the upper system's merge.  Full
  byte and cache accounting lives here.
* :class:`DriveLoop` — the device-resident fused path, detected when the
  daemon can ``run_all_shards``
  (:class:`~repro_torch.plug.protocols.ShardCapableDaemon`), the upper
  system can ``merge_partials``
  (:class:`~repro_torch.plug.protocols.DevicePartialUpper`) over an exact
  wire, and the model is BSP or GAS: each iteration runs gather + Gen +
  segmented Merge for all shards, the partial merge, Apply and the
  convergence check on the device, and fetches one small tensor.
* :class:`AsyncDriveLoop` — the fused loop of the asynchronous priority
  model (:class:`~repro_torch.plug.protocols.PriorityAsyncModel`, e.g.
  ``model="async"``), with the same capabilities plus the upper's
  ``merge_partials_async``: the step also carries the model's scheduling
  state on the device (per-device held partials and counts, the frontier
  backlog gathered while a device holds, the decaying threshold), and a
  held device runs no gather, Gen or Merge.  Which devices hold in
  iteration t + 1 is decided at the end of step t and rides its one fetch,
  so the hold is decided on the host at no extra sync.
* :class:`OocoreDriveLoop` — the barriered fused step out of core, with
  ``oocore=`` (an :class:`~repro_torch.oocore.OocoreConfig`) and a daemon
  that can bind super-shards
  (:class:`~repro_torch.plug.protocols.OutOfCoreCapable`): a hot set of
  columns stays on the device, the rest streams from pinned host memory on
  a copy stream, group by group, into one merge an iteration.

Between fused iterations the middleware polls its structure triggers — a
:class:`~repro_torch.dist.fault.FailureSchedule` or
:class:`~repro_torch.dist.fault.FleetMonitor` (kills, joins, stragglers
on the shard axis' logical devices) and a
:class:`~repro_torch.graph.mutation.MutationSchedule` (graph mutation
batches) — and every rebuild, with :meth:`Middleware.rebalance` and
:meth:`Middleware.apply_mutations` between runs, is one versioned event on
its :class:`~repro_torch.plug.epoch.StructureEpochBus`; the loops adopt it
without a checkpoint.
"""
from __future__ import annotations

import inspect
import itertools
import time

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.balance import CapacityEstimator, lemma2_fractions
from repro_torch.core.blocks import build_blocks, widen_vblocks
from repro_torch.core.pow2 import next_pow2
from repro_torch.core.sync import LRUVertexCache, SyncStats, can_skip_sync
from repro_torch.core.template import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.dist import fault as dist_fault
from repro_torch.dist.sharding import LOCAL_MESH, LocalMesh, RankMesh
from repro_torch.graph import mutation as graph_mutation
from repro_torch.graph.structure import EdgePartition, Graph
from repro_torch.oocore.prefetch import AsyncUploader
from repro_torch.plug.computation import BSP, GAS, AsyncModel, get_model
from repro_torch.plug.daemons import get_daemon
from repro_torch.plug.epoch import StructureEpoch, StructureEpochBus
from repro_torch.plug.protocols import (DevicePartialUpper, ElasticUpper,
                                        MaskCapableDaemon, OutOfCoreCapable,
                                        PlugOptions, PriorityAsyncModel,
                                        Result, ShardCapableDaemon,
                                        divisor_mesh)
from repro_torch.plug.uppers import get_upper_system

# names the channels on which a survivor group's leader posts to the idle
# ranks: every rank builds its middlewares over a RankMesh in the same order
_CHANNELS = itertools.count()

# Computation-model orders the barriered fused loop realizes.  BSP and GAS
# produce identical state trajectories on the same template
# (``plug.computation``), so one fused step serves both; a priority/async
# model gets its own fused step (AsyncDriveLoop); any other model keeps the
# host loop, which calls the model's hooks.
_FUSABLE_ORDERS = {("gen", "merge", "apply"), ("merge", "apply", "gen")}
_MODEL_HOOKS = ("prologue", "aggregates", "epilogue")


def _model_is_fusable(model) -> bool:
    """True iff the model's trajectory is the one the fused step realizes:
    a BSP/GAS order AND the three hooks exactly as BSP or GAS implements
    them — a subclass overriding a hook keeps the host loop that calls
    it."""
    if tuple(getattr(model, "order", ())) not in _FUSABLE_ORDERS:
        return False
    cls = type(model)
    return any(
        all(getattr(cls, h, None) is getattr(base, h) for h in _MODEL_HOOKS)
        for base in (BSP, GAS))


def _async_model_is_fusable(model) -> bool:
    """True iff the model's trajectory is what the fused async step
    realizes: the :class:`~repro_torch.plug.protocols.PriorityAsyncModel`
    state AND the three hooks exactly as ``AsyncModel`` implements them —
    the fused step never calls the hooks, so a subclass overriding one
    keeps the host loop that does."""
    if not isinstance(model, PriorityAsyncModel):
        return False
    cls = type(model)
    return all(getattr(cls, h, None) is getattr(AsyncModel, h)
               for h in _MODEL_HOOKS)


def apply_step(program: VertexProgram, state, merged, has_msg, aux, it):
    """MSGApply on tensors, where they lie → ``(new_state, active)``; every
    drive loop applies through it."""
    # Vertices with no message keep identity-merged values; msg_apply
    # implementations treat identity correctly (min/max) or use has_msg.
    merged = torch.where(has_msg[:, None], merged,
                         torch.full_like(merged, program.monoid.identity))
    new, active = program.msg_apply(state, merged, has_msg[:, None], aux, it)
    if program.is_batched_query():
        # Per-query convergence masking (BatchQueryCapable): a query whose
        # columns went quiet is FROZEN by reverting them and dropped from
        # the shared frontier — finished queries exit early while their
        # batch-mates keep running.  It lives here, in the one apply every
        # drive loop shares, so all loops mask identically; the flags stay
        # tensors on the state's device (no fetch).
        qact = program.query_activity(state, new)         # (N, B) bool
        q_run = qact.any(dim=0)                           # (B,) still going
        per_q = new.shape[1] // program.num_queries
        colmask = torch.repeat_interleave(q_run, per_q)   # (K,)
        new = torch.where(colmask[None, :], new, state)
        # a frozen query has no active vertex, so the frontier is the
        # running queries' activity
        active = qact.any(dim=1)
    return new, active


def make_apply_fn(program: VertexProgram, device="cuda"):
    """:func:`apply_step` on ``device`` for the host loop: host arrays in,
    host arrays out."""
    dev = resolve_device(device)

    def apply_fn(state, merged, has_msg, aux, it):
        new, active = apply_step(
            program, *(torch.as_tensor(x, device=dev)
                       for x in (state, merged, has_msg, aux)), it)
        return new.cpu().numpy(), active.cpu().numpy()

    return apply_fn


def _rank_mesh_of(upper, daemon) -> RankMesh | LocalMesh:
    """The RankMesh a composition runs over, or ``LOCAL_MESH`` on one
    process.  The upper system holds it (only an upper that merges across
    ranks may); a daemon's mesh must then be None or the same mesh."""
    um = getattr(upper, "mesh", None)
    dm = getattr(daemon, "mesh", None)
    if not isinstance(um, RankMesh):
        if isinstance(dm, RankMesh):
            raise ValueError("a daemon over a RankMesh needs an upper system "
                             "that merges across ranks: "
                             "MeshUpperSystem(mesh=<the same RankMesh>)")
        return LOCAL_MESH
    if dm is not None and dm is not um:
        raise ValueError(f"the daemon's mesh {dm!r} is not the upper "
                         f"system's {um!r}")
    return um


class Middleware:
    """Drives a VertexProgram through pluggable components.

    Args:
      graph, program: the workload.
      daemon: accelerator backend — a registry name (``"reference"``,
        ``"cuda"``, ``"sharded"``, ``"blocked"``, ``"pipelined"``,
        ``"naive"``, …) or an unbound Daemon instance.
      upper: upper system — ``"host"`` / ``"mesh"`` or an instance.
      model: computation model — ``"bsp"`` / ``"gas"`` / ``"async"`` or an
        instance.
      partitions: explicit edge partitions; defaults to the upper
        system's partitioner over ``num_shards``.
      capacities: per-shard per-entity costs c_j; shard sizes follow
        Lemma 2.  Ignored when explicit ``partitions`` are given.
      monitor: a :class:`~repro_torch.dist.fault.FleetMonitor` with one
        slot per logical device of the fused shard axis — enables elastic
        fault tolerance: between fused iterations the middleware polls the
        monitor and, on a device failure, a recovered device or a fresh
        straggler, migrates the live run onto a survivor axis without a
        checkpoint.  Requires a fused loop (``daemon="sharded"``,
        ``upper="mesh"`` with an exact wire).
      failures: a :class:`~repro_torch.dist.fault.FailureSchedule`
        injecting deterministic kills, recoveries and straggler reports
        into the monitor ("kill device d at iteration k").  Implies a
        monitor (one is created if not given).
      mutations: a :class:`~repro_torch.graph.mutation.MutationSchedule`
        injecting graph-mutation batches between fused iterations ("apply
        batch b at iteration k").  The run continues incrementally (the
        dirty frontier re-activated) when the monoid is idempotent and the
        batch only adds, else the carried state resets (a cold restart
        mid-run).  Needs a fused loop; between runs, use
        :meth:`apply_mutations` / :meth:`run_dynamic`.
      oocore: an :class:`~repro_torch.oocore.OocoreConfig` — out-of-core
        execution.  The daemon keeps a hot set of its columns on the device
        and streams the rest as super-shards from pinned host memory
        (:class:`OocoreDriveLoop`).  Needs the barriered fused composition
        (``daemon="sharded"``, ``upper="mesh"``, BSP or GAS); any other
        raises rather than running resident.
      options: :class:`~repro_torch.plug.protocols.PlugOptions`.
      device: where the daemon and MSGApply run; ``"cuda"`` (the
        default) raises on a machine without a GPU.  Over a
        :class:`~repro_torch.dist.sharding.RankMesh` it is the mesh's
        device (a ``device`` that differs raises).

    Across ranks: with ``upper=MeshUpperSystem(mesh=rm)`` for a RankMesh
    ``rm`` (and ``daemon=ShardedDaemon(mesh=rm)`` or no mesh on the daemon
    for the fused loop), every rank builds this middleware with the same
    arguments.  Each runs the same deterministic partitioner, then builds
    blocks for, and binds, only the shards it owns
    (:meth:`~repro_torch.dist.sharding.RankMesh.shard_range`); the merges
    are collectives, so state and frontier stay replicated, bit-identical
    on every rank, and every rank's ``Result`` and records are the same
    (but a daemon's own record entries, which list the rank's blocks).
    One process runs the same code over ``LOCAL_MESH``, whose collectives
    return their input.  The fused async loop runs across ranks too: a rank
    carries the scheduling state of its own logical devices, and the hold
    verdict rides one small ``all_reduce`` an iteration.

    Structure epochs across ranks: every rank holds the graph and the same
    monitor, schedules and partitions, so every rank makes the same plan —
    m′, the survivor devices, the Lemma-2 assignment or re-partition, the
    mutated partitions — and builds blocks only for the shards its devices
    own under it; no graph data moves.  A kill, straggler or join re-meshes
    onto a survivor :meth:`~repro_torch.dist.sharding.RankMesh.survivors`
    mesh, whose group is the ranks that host its devices.  A rank that
    hosts none is *idle*: it stays in the run until it ends, takes part in
    every ``new_group`` the survivors make, replays the survivors' polls
    when their leader posts one (a membership change) and rejoins on a
    join, getting the carry by a broadcast; at the end it takes the
    leader's ``Result``, so every world rank returns the same one.  Out of
    core across ranks, each rank streams its own shards' columns of every
    super-shard under the plan one process would make (see
    :class:`OocoreDriveLoop`); ``oocore_replan``, like ``rebalance``, is
    called on every world rank.

    With a shard-capable daemon (``daemon="sharded"``) and a device-partial
    upper system (``upper="mesh"``), ``run`` drives the fused
    :class:`DriveLoop` for a BSP/GAS model and the fused
    :class:`AsyncDriveLoop` for ``AsyncModel``, and with ``oocore=`` the
    :class:`OocoreDriveLoop`; otherwise the :class:`HostDriveLoop`.

    Every structure rebuild — kill, join, rebalance, out-of-core re-plan,
    mutation — is published on ``self.epochs`` (a
    :class:`~repro_torch.plug.epoch.StructureEpochBus`); the subscribed
    hooks re-target the upper system, re-stack the daemon's block tensors
    and restart the capacity windows, in that order.  Drive loops react to
    the bus version between iterations and never rebuild anything
    themselves.
    """

    def __init__(
        self,
        graph: Graph,
        program: VertexProgram,
        *,
        daemon="reference",
        upper="host",
        model="bsp",
        partitions: list[EdgePartition] | None = None,
        num_shards: int = 1,
        capacities=None,
        monitor: "dist_fault.FleetMonitor | None" = None,
        failures: "dist_fault.FailureSchedule | None" = None,
        mutations: "graph_mutation.MutationSchedule | None" = None,
        oocore=None,
        options: PlugOptions | None = None,
        device=None,
    ):
        self.graph = graph
        self.program = program
        self.options = options or PlugOptions()
        self.oocore = oocore  # OocoreConfig | None — out-of-core execution
        self.daemon = get_daemon(daemon) if isinstance(daemon, str) else daemon
        self.upper = (get_upper_system(upper) if isinstance(upper, str)
                      else upper)
        self.model = get_model(model) if isinstance(model, str) else model
        self.ranks = _rank_mesh_of(self.upper, self.daemon)
        if not isinstance(self.ranks, RankMesh):
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = self.ranks.device_for(device)
        # the leader's posts to idle ranks: their channel, how many were
        # made, and the polls they replay (see _poll_structure)
        self._channel = (f"mw{next(_CHANNELS)}"
                         if isinstance(self.ranks, RankMesh) else None)
        self._posts = 0
        self._polled = 0  # the last iteration polled in this run
        self._poll_it = None  # the iteration whose poll is running
        self._replaying = False

        self._owns_partitions = partitions is None
        if partitions is None:
            if capacities is not None:
                c = np.asarray(capacities, dtype=np.float64)
                if c.shape != (num_shards,):
                    raise ValueError(
                        f"capacities must have shape ({num_shards},), got "
                        f"{c.shape}")
                partitions = self.upper.partition(
                    graph, num_shards, fractions=lemma2_fractions(c))
            else:
                partitions = self.upper.partition(graph, num_shards)
        self.partitions = list(partitions)
        self.num_shards = len(self.partitions)
        # the shards this process owns: all of them, or the rank's
        self.shards = self.ranks.shard_range(self.num_shards)
        self.n = graph.num_vertices
        self.k = program.state_width
        self._setup_blocks()

        self.daemon.bind(program, self.n, device=self.device)
        self.upper.bind(program, self.num_shards, device=self.device)
        self._apply_fn = make_apply_fn(program, self.device)
        self.stats = SyncStats()
        self._caches: list[LRUVertexCache] = []  # created per-run by run()
        self._estimator = CapacityEstimator(self.num_shards)
        self._fused_kind = self._detect_fused()
        self._fused = self._fused_kind is not None
        self.oocore_stats: dict = {}
        if self._fused_kind == "oocore":
            self.daemon.bind_super_shards(self.blocksets,
                                          mesh=self.upper.mesh,
                                          axis=self.upper.axis,
                                          config=self.oocore)
        elif self._fused:
            self.daemon.bind_shards(self.blocksets, mesh=self.upper.mesh,
                                    axis=self.upper.axis)

        # -- elastic fault tolerance ----------------------------------------
        self.monitor = monitor
        self.failures = failures
        self._mesh_device_ids: list[int] = []
        self._handled_stragglers: set[int] = set()
        if monitor is not None or failures is not None:
            if not self._fused:
                raise ValueError(
                    "elastic fault tolerance (monitor=/failures=) needs the "
                    "fused device-resident loop: a shard-capable daemon "
                    "(daemon='sharded') with a device-partial upper system "
                    "over an exact wire (upper='mesh') and a fusable model")
            if not isinstance(self.upper, ElasticUpper):
                raise ValueError(
                    f"upper system {type(self.upper).__name__} cannot "
                    "remesh/migrate (see plug.protocols.ElasticUpper)")
            # the fleet is the shard axis' logical devices, ids 0 … m0 − 1;
            # across ranks the world's, rank r hosting r·local … (r+1)·local
            # − 1
            m0 = divisor_mesh(self.num_shards, self.upper.mesh)
            axis = list(range(m0))
            if isinstance(self.ranks, RankMesh):
                m0 = self.ranks.world_size * self.ranks.world_local
                axis = list(self.ranks.device_ids)
            self.fleet_devices = list(range(m0))
            if self.monitor is None:
                self.monitor = dist_fault.FleetMonitor(num_hosts=m0,
                                                       model_parallel=1)
            if self.monitor.num_hosts != m0:
                raise ValueError(
                    f"monitor tracks {self.monitor.num_hosts} hosts but the "
                    f"fused shard axis has {m0} devices — one monitor slot "
                    "per logical device")
            self._mesh_device_ids = axis
            # the initial placement acknowledges what the monitor already
            # knows; straggler migrations key off drift from this baseline
            self.monitor.ack_capacity()

        # -- dynamic graphs --------------------------------------------------
        self.mutations = mutations
        if mutations is not None and not self._fused:
            raise ValueError(
                "a mid-run MutationSchedule needs a fused device-resident "
                "loop (the host loop re-reads the graph every iteration "
                "and never polls for due batches); apply batches between "
                "runs with apply_mutations() instead")
        self.last_restart: dict | None = None
        self._last_state: np.ndarray | None = None

        # -- the structure-epoch layer (plug/epoch.py) -----------------------
        # Every rebuild trigger publishes here; the hooks run in this order:
        # the upper's shard axis first, the block tensors second, the
        # capacity windows last.
        self.epochs = StructureEpochBus()
        self.epochs.subscribe("upper", self._epoch_upper)
        self.epochs.subscribe("daemon", self._epoch_daemon)
        self.epochs.subscribe("capacity", self._epoch_capacity)
        self.epochs.initialize(StructureEpoch(
            version=0, cause="init",
            mesh=self.upper.mesh if self._fused else None,
            partitions=tuple(self.partitions),
            blocksets=tuple(self.blocksets),
            oocore_plan=(self.daemon.oocore_plan
                         if self._fused_kind == "oocore" else None)))
        self._loop = {"bsp": DriveLoop, "async": AsyncDriveLoop,
                      "oocore": OocoreDriveLoop,
                      None: HostDriveLoop}[self._fused_kind](self)

    # -- structure-epoch rebuild hooks -------------------------------------
    def _epoch_upper(self, new: StructureEpoch, old) -> None:
        """Re-targets the upper system at the epoch's shard axis (fused) or
        re-binds it for the new shard layout (host path)."""
        if self._fused:
            self.upper.remesh(new.mesh)
        else:
            self.upper.bind(self.program, self.num_shards,
                            device=self.device)

    def _epoch_daemon(self, new: StructureEpoch, old) -> None:
        """Re-stacks the daemon's block tensors for the epoch (fused).  Out
        of core, the daemon re-plans its super-shards and fills
        ``new.oocore_plan``: the plan is an output of the rebuild, not an
        input to it; an ``oocore_config`` in the epoch's meta re-binds
        under that new budget.  On the host path blocks go to the device
        every iteration, so nothing is re-placed: stale per-blockset caches
        are pruned instead."""
        if self._fused:
            self.daemon.remesh(new.mesh, blocksets=list(new.blocksets),
                               config=new.meta.get("oocore_config"))
            if self._fused_kind == "oocore":
                new.oocore_plan = self.daemon.oocore_plan
        else:
            prune = getattr(self.daemon, "prune_block_caches", None)
            if prune is not None:
                prune(new.blocksets)

    def _epoch_capacity(self, new: StructureEpoch, old) -> None:
        """Restarts capacity estimation under the new epoch: per-shard
        costs measured against the old structure say nothing about the new
        one, so the estimator is replaced and the fleet monitor's step-time
        windows are re-keyed (``FleetMonitor.on_epoch``)."""
        self._estimator = CapacityEstimator(self.num_shards,
                                            epoch=new.version)
        if self.monitor is not None:
            self.monitor.on_epoch(new.version)

    # -- setup ------------------------------------------------------------
    def _resolve_block_size(self) -> int:
        o = self.options
        if o.block_size == "auto":
            d = max(1, max(p.num_edges for p in self.partitions))
            best_b, _ = pl.optimal_integer_blocks(d, o.k1, o.k2, o.k3, o.a)
            return int(min(max(best_b, 64), 1 << 16))
        return int(o.block_size)

    def _setup_blocks(self) -> None:
        """Blocks for the shards this process owns (``self.blocksets[i]``
        is shard ``self.shards[i]``'s), at one vertex-block width for all
        shards — the widest, agreed across the ranks — so one launch shape
        serves them."""
        b = self._resolve_block_size()
        self.block_size = b
        blocksets = [build_blocks(self.partitions[j], b) for j in self.shards]
        vb = self._agree(max((bs.vblock_size for bs in blocksets), default=0))
        self.blocksets = [widen_vblocks(bs, vb) for bs in blocksets]
        self.vblock_size = vb

    def _agree(self, value: int) -> int:
        """The largest ``value`` over the ranks of the mesh (this one's on
        one process or on an idle rank, whose value the group never
        reads)."""
        if self.ranks.idle:
            return int(value)
        return int(self.ranks.all_reduce_host(np.array([value]), "max")[0])

    def _blocks_total(self) -> int:
        """Every shard's block count, summed over the ranks."""
        total = sum(bs.num_blocks for bs in self.blocksets)
        return int(self.ranks.all_reduce_host(np.array([total]), "sum")[0])

    def _detect_fused(self) -> str | None:
        """Which fused device-resident loop this composition gets, if any.
        Both need a shard-capable daemon and an upper system that merges
        device partials over an exact wire; the model then picks the step:
        BSP/GAS share the barriered one (``"bsp"``), a priority/async model
        whose upper also has ``merge_partials_async`` gets the async one
        (``"async"``), and anything else gets None (the host loop, which
        drives the model's hooks).  With ``oocore=`` the answer is
        ``"oocore"`` or a ``ValueError``: an unfused composition, a daemon
        that cannot bind super-shards or the async model is refused."""
        caps = (isinstance(self.daemon, ShardCapableDaemon)
                and isinstance(self.upper, DevicePartialUpper)
                and getattr(self.upper, "wire", "exact") == "exact")
        if self.oocore is not None:
            # out-of-core is opt-in and never falls back: a composition
            # that cannot stream super-shards is a configuration error, not
            # a reason to run resident anyway
            if not caps:
                raise ValueError(
                    "oocore= needs the fused device-resident loop: a "
                    "shard-capable daemon (daemon='sharded') with a "
                    "device-partial upper system over an exact wire "
                    "(upper='mesh')")
            if not isinstance(self.daemon, OutOfCoreCapable):
                raise ValueError(
                    f"daemon {type(self.daemon).__name__} cannot bind "
                    "super-shards (see plug.protocols.OutOfCoreCapable)")
            if not _model_is_fusable(self.model):
                raise ValueError(
                    "oocore= supports the barriered BSP/GAS step only — "
                    "the async model's held partials assume the full "
                    "column range is resident every iteration")
            return "oocore"
        if not caps:
            return None
        if _model_is_fusable(self.model):
            return "bsp"
        if (_async_model_is_fusable(self.model)
                and callable(getattr(self.upper, "merge_partials_async",
                                     None))):
            return "async"
        return None

    # -- the drive loop ---------------------------------------------------
    def run(self, max_iterations: int | None = None, *,
            init=None, frontier=None) -> Result:
        """Drives the program to convergence.

        ``init`` overrides ``program.init`` for this run only
        (``init(graph) -> (state0, aux)``, same shapes); ``frontier``
        overrides the initial active mask (default: every vertex) — the
        seam :meth:`run_dynamic` resumes through.
        """
        # Fresh per-run accounting: stats and LRU caches reset at loop entry.
        self.stats = SyncStats()
        self._caches = [
            LRUVertexCache(self.options.cache_capacity)
            for _ in range(self.num_shards)
        ]
        res = self._loop.run(max_iterations, init=init, frontier=frontier)
        # the previous fixed point the next run_dynamic() may resume from
        self._last_state = np.asarray(res.state)
        return res

    # -- between-iteration structure polling -------------------------------
    def _poll_structure(self, it: int) -> dict:
        """The between-iteration poll of the fused drive loops: feeds due
        failure-schedule events and due mutation batches through their
        structure-epoch publishers.  Returns the extra entries for the
        iteration record ({} when nothing fired; host work only, and none
        without a monitor or a mutation schedule) — the loop reacts to the
        bus *version*, never to this dict, so externally triggered
        publishes are adopted the same way."""
        out: dict = {}
        self._poll_it = it
        try:
            if self.monitor is not None:
                mig = self._poll_faults(it)
                if mig is not None:
                    out["migration"] = mig
            mut = self._poll_mutations(it)
            if mut is not None:
                out["mutation"] = mut
        finally:
            self._poll_it = None
        self._polled = it
        return out

    # -- idle ranks ---------------------------------------------------------
    def _idle_ranks(self) -> bool:
        """True when some world rank sits outside the mesh's group."""
        rm = self.ranks
        return isinstance(rm, RankMesh) and len(rm.members) < rm.world_size

    def _rank_joined(self) -> bool:
        """True on a rank the last re-mesh brought back from idle."""
        return self.ranks.rank in getattr(self.upper, "joined", ())

    def _post(self, message) -> None:
        """The group's leader posts ``message`` to the idle ranks; every
        member counts it, so the next post's key is the same everywhere."""
        if self.ranks.rank == self.ranks.leader:
            self.ranks.post(f"{self._channel}/{self._posts}", message)
        self._posts += 1

    def _wake_idle(self, device_ids) -> None:
        """Before a mid-run membership change: the idle ranks must make the
        same ``new_group`` calls, so the leader posts the poll's iteration
        and they replay the polls up to it (:meth:`_sit_out`).  Between
        runs every rank calls the trigger itself, and a replaying rank is
        the one woken."""
        if self._replaying or self._poll_it is None or not self._idle_ranks():
            return
        rm = self.ranks
        members = tuple(sorted({int(d) // rm.world_local
                                for d in device_ids}))
        if members != rm.members:
            self._post(("poll", self._poll_it, None))

    def _sit_out(self):
        """An idle rank's part of a run: waits for the leader's posts and
        replays the survivors' polls up to each (the same plans, epochs and
        ``new_group`` calls, with no blocks to build).  Returns the
        leader's ``Result`` at the end of the run, or ``(iteration,
        record entries)`` when a join brought this rank back."""
        while True:
            kind, it, result = self.ranks.wait_post(
                f"{self._channel}/{self._posts}")
            self._posts += 1
            self._replaying = True
            try:
                ev: dict = {}
                for t in range(self._polled + 1, it + 1):
                    ev = self._poll_structure(t)
            finally:
                self._replaying = False
            if kind == "done":
                self.stats = result.stats
                return result
            if not self.ranks.idle:
                return it, ev

    def _poll_mutations(self, it: int) -> dict | None:
        """Applies the mutation batches due at iteration ``it``.  Each batch
        publishes its own epoch; when several are due at once the final
        epoch's meta is widened (frontier union, incremental AND), so the
        loop's one adoption of the latest version loses nothing."""
        if self.mutations is None:
            return None
        due = self.mutations.due_at(it)
        if not due:
            return None
        t0 = time.perf_counter()
        eps = [self.apply_mutations(b) for b in due]
        # an all-empty batch publishes nothing and returns the current
        # epoch, whose meta carries no frontier — drop it
        eps = [e for e in eps if e.meta.get("frontier") is not None]
        if not eps:
            return None
        ep = eps[-1]
        for e in eps[:-1]:
            ep.meta["frontier"] = ep.meta["frontier"] | e.meta["frontier"]
            ep.meta["incremental"] = (ep.meta["incremental"]
                                      and e.meta["incremental"])
        return {
            "batches": len(due),
            "edges_added": sum(e.meta["edges_added"] for e in eps),
            "edges_removed": sum(e.meta["edges_removed"] for e in eps),
            "dirty_vertices": int(sum(e.meta["dirty_count"] for e in eps)),
            "incremental": bool(ep.meta["incremental"]),
            "seconds": time.perf_counter() - t0,
        }

    # -- elastic fault tolerance ------------------------------------------
    def _poll_faults(self, it: int) -> dict | None:
        """The between-iteration elastic check of the fused drive loops.

        Feeds the failure schedule's due events into the monitor (step-time
        reports, recoveries, then kills) and migrates when a dead device
        sits in the active shard axis, when recovered devices let it grow,
        when a straggler is flagged for the first time, or when a handled
        straggler's capacity kept drifting past the monitor's threshold
        since the placement last acknowledged it.  Returns the migration
        record for the iteration log, or None when the fleet is healthy.
        """
        mon = self.monitor
        if mon is None:
            return None
        newly: list[int] = []
        rejoined: list[int] = []
        if self.failures is not None:
            for dev, seconds in self.failures.slow_reports(it):
                if not mon.failed[dev]:
                    mon.record(dev, seconds)
            for dev in self.failures.recoveries_at(it):
                if mon.failed[dev]:
                    mon.mark_recovered(dev)
                    rejoined.append(dev)
            for dev in self.failures.kills_at(it):
                if not mon.failed[dev]:
                    mon.mark_failed(dev)
                    newly.append(dev)
        failed = mon.failed
        if any(failed[d] for d in self._mesh_device_ids):
            return self.migrate(killed=newly, joined=rejoined)
        if self._feasible_mesh_size() > len(self._mesh_device_ids):
            # elastic JOIN: keyed off the monitor's fleet view, not the
            # consumed recovery event, so every middleware sharing this
            # monitor grows at its own next poll
            return self.migrate(joined=rejoined)
        if self._owns_partitions:
            # only stragglers that carry shards warrant a migration
            flagged = [int(d) for d in np.nonzero(mon.stragglers())[0]
                       if int(d) in self._mesh_device_ids]
            fresh = [d for d in flagged
                     if d not in self._handled_stragglers]
            # a straggler seen before still warrants a migration when its
            # capacity kept degrading after the placement that absorbed it
            if fresh or (flagged and mon.drifted()):
                self._handled_stragglers.update(fresh)
                return self.migrate(stragglers=fresh or flagged)
        return None

    def _feasible_mesh_size(self) -> int:
        """Largest shard-axis length the surviving fleet can host: the
        largest divisor of ``num_shards`` ≤ the number of alive devices.
        Shrink and grow are the same computation."""
        alive = int(self.monitor.alive_hosts)
        for d in range(min(self.num_shards, alive), 0, -1):
            if self.num_shards % d == 0:
                return d
        return 1

    def migrate(self, *, killed=(), stragglers=(), joined=()) -> dict:
        """Checkpoint-free elastic migration onto the survivor shard axis.

        Re-plans the shard placement from the monitor's view of the fleet
        and re-targets the fused composition:

        1. the new axis length m′ is the largest divisor of ``num_shards``
           the survivors can host, and the m′ devices with the highest
           Lemma-2 capacity are kept;
        2. every shard — the dead devices' orphans in particular — is
           reassigned to a survivor with
           :func:`~repro_torch.dist.fault.reassign_shards` (Lemma-2
           entitlement, ``cap = num_shards // m′`` so the stacked layout
           stays rectangular);
        3. with capacity data (step-time reports), the graph is
           re-partitioned so each device's shard slots carry edges in
           proportion to its Lemma-2 fraction; without data — or on
           caller-supplied partitions — the partitions are kept and only
           re-ordered onto their new devices (the same blocks, another
           placement);
        4. the rebuild is *published* as a structure epoch (cause
           ``"kill"`` / ``"join"`` / ``"rebalance"``) whose ``mesh`` is
           the int m′: the hooks re-target the upper system
           (``MeshUpperSystem.remesh``), re-stack the daemon's block
           tensors (``ShardedDaemon.remesh``) and restart capacity
           estimation.

        The fused drive loop sees the version change at its next poll and
        re-places its carry; the vertex state stays on the card.  Also
        callable directly after ``monitor.mark_failed(...)`` (across ranks,
        on every rank).  Returns the record: ``killed``, ``stragglers``,
        ``joined``, ``devices_before``, ``devices_after``, ``device_ids``,
        ``assignment``, ``repartitioned``, ``dirty_vertices`` and
        ``seconds``.

        Across ranks every rank makes this plan, and the epoch's ``mesh`` is
        the survivor :class:`~repro_torch.dist.sharding.RankMesh` of the m′
        devices (made on every world rank, idle ones included).  A rank then
        builds blocks for the shards its devices own: a re-partition's, or
        after a re-placement only those it did not hold already.
        """
        t0 = time.perf_counter()
        mon = self.monitor
        if mon is None:
            raise ValueError("migrate() needs a Middleware(monitor=...)")
        alive = [int(d) for d in mon.alive_indices()]
        if not alive:
            raise ValueError("no surviving devices to migrate onto")
        m_new = self._feasible_mesh_size()
        frac_fleet = mon.batch_fractions()  # dead hosts are exactly 0
        order = sorted(alive, key=lambda d: (-frac_fleet[d], d))
        chosen = sorted(order[:m_new])
        frac = np.asarray(frac_fleet[chosen], dtype=np.float64)
        frac = (np.full(m_new, 1.0 / m_new) if frac.sum() <= 0
                else frac / frac.sum())
        cap = self.num_shards // m_new
        assign = dist_fault.reassign_shards(self.num_shards, frac, cap=cap)
        perm = np.argsort(assign, kind="stable")  # device-major slot order
        m_old = len(self._mesh_device_ids)
        cap_old = self.num_shards // max(1, m_old)
        repartitioned = self._owns_partitions and mon.observed
        before = self.ranks
        if isinstance(before, RankMesh):
            self._wake_idle(chosen)
            self.ranks = before.survivors(chosen)
        held = dict(zip(self.shards, self.blocksets))
        self.shards = self.ranks.shard_range(self.num_shards)
        if repartitioned:
            # capacity-aware re-partition: device chosen[i] holds `cap`
            # slots, each sized frac[i]/cap of the edges (Lemma 2)
            slot_frac = np.repeat(frac / cap, cap)
            self.partitions = list(self.upper.partition(
                self.graph, self.num_shards, fractions=slot_frac))
            self._setup_blocks()
            dirty = None  # arbitrary edges changed shards: no vertex clean
        else:
            # Pure re-placement.  A vertex's merged value depends only on
            # the device grouping of the shards holding its in-edges, so at
            # an unchanged axis length only the destinations of shards that
            # moved device are dirty; a changed length re-reduces all.
            if m_new != m_old:
                dirty = None
            else:
                moved = [int(perm[s]) for s in range(self.num_shards)
                         if (self._mesh_device_ids[int(perm[s]) // cap_old]
                             != chosen[s // cap])]
                dirty = (np.empty(0, np.int64) if not moved
                         else np.unique(np.concatenate(
                             [self.partitions[j].dst for j in moved]
                         ).astype(np.int64)))
            self.partitions = [self.partitions[int(i)] for i in perm]
            # reorder, don't rebuild: the BlockSet objects keep their
            # identity, so the daemon's per-blockset tiles stay cached
            self.blocksets = self._place_blocksets(
                [int(perm[s]) for s in self.shards], held,
                stale=before.idle)
        ids_before, self._mesh_device_ids = (self._mesh_device_ids,
                                             list(chosen))
        record = {
            "killed": [int(d) for d in killed],
            "stragglers": [int(d) for d in stragglers],
            "joined": [int(d) for d in joined],
            "devices_before": len(ids_before),
            "devices_after": m_new,
            "device_ids": [int(d) for d in chosen],
            "assignment": [int(a) for a in assign],
            "repartitioned": bool(repartitioned),
            "dirty_vertices": (None if dirty is None
                               else [int(v) for v in dirty]),
        }
        cause = ("kill" if killed
                 else "join" if (joined or m_new > m_old) else "rebalance")
        self.epochs.publish(
            cause, mesh=(self.ranks if isinstance(self.ranks, RankMesh)
                         else m_new),
            partitions=self.partitions, blocksets=self.blocksets,
            dirty_vertices=dirty, meta=record)
        record["seconds"] = time.perf_counter() - t0
        return record

    def _place_blocksets(self, sources, held, *, stale=False) -> list:
        """The blocksets of this process's shards after a re-placement:
        shard ``i`` takes what was shard ``sources[i]``.  Those this
        process held are kept (their tiles stay cached); across ranks the
        others are built from their unchanged partitions, and the width is
        agreed again over the new group (a rank back from idle, ``stale``,
        offers none of its own)."""
        sets = [held.get(j) for j in sources]
        if not isinstance(self.ranks, RankMesh):
            return sets
        sets = [bs if bs is not None else
                build_blocks(self.partitions[j], self.block_size)
                for j, bs in zip(self.shards, sets)]
        self.vblock_size = self._agree(max(
            [0 if stale else self.vblock_size]
            + [bs.vblock_size for bs in sets]))
        return [widen_vblocks(bs, self.vblock_size) for bs in sets]

    # -- Lemma-2 rebalancing ----------------------------------------------
    def rebalance(self, capacities=None) -> np.ndarray:
        """Capacity-aware re-assignment of blocks to shards (Lemma 2).

        Uses explicit per-entity costs when given; otherwise the costs the
        :class:`~repro_torch.core.balance.CapacityEstimator` learned from
        the host loop's per-shard busy times, or the fleet monitor's
        per-device step times.  Re-partitions the graph with
        ``lemma2_fractions``, rebuilds the block sets, publishes a
        ``"rebalance"`` epoch (whose hooks re-stack the sharded daemon's
        block tensors) and returns the fractions used.

        The fused loops time all shards as one program and observe no
        per-shard busy times, so a fused-only middleware needs explicit
        ``capacities`` (or a reporting monitor).  A middleware built on
        caller-supplied ``partitions`` refuses: re-partitioning would
        replace the caller's partitioning with the upper system's default.
        """
        if not self._owns_partitions:
            raise ValueError(
                "rebalance() would replace the explicit partitions this "
                "Middleware was constructed with by the upper system's "
                "default partitioner; construct without partitions= (or "
                "with capacities=) to let the middleware own the "
                "assignment")
        if capacities is not None:
            c = np.asarray(capacities, dtype=np.float64)
            if c.shape != (self.num_shards,):
                raise ValueError(
                    f"capacities must have shape ({self.num_shards},), got "
                    f"{c.shape}")
        elif self._estimator.observed:
            c = self._estimator.costs
        elif self.monitor is not None and self.monitor.observed:
            # the monitor's per-device step times of the CURRENT axis'
            # devices stand in; dead devices are never in it
            t = self.monitor.mean_times()[self._mesh_device_ids]
            fill = np.nanmean(t) if np.any(np.isfinite(t)) else 1.0
            t = np.where(np.isfinite(t), t, fill)
            c = np.repeat(t, self.num_shards // len(self._mesh_device_ids))
        else:
            raise ValueError(
                "rebalance() has no observed per-shard busy times (the "
                "fused drive loop times all shards as one program) — pass "
                "capacities= explicitly, attach a reporting "
                "FleetMonitor, or run the host path first")
        fractions = lemma2_fractions(c)
        self.partitions = list(self.upper.partition(
            self.graph, self.num_shards, fractions=fractions))
        self._setup_blocks()
        self.epochs.publish(
            "rebalance",
            mesh=self.upper.mesh if self._fused else None,
            partitions=self.partitions, blocksets=self.blocksets,
            dirty_vertices=None,  # edges changed shards arbitrarily
            meta={"fractions": [float(f) for f in fractions]})
        return fractions

    def oocore_replan(self, config=None) -> StructureEpoch:
        """Re-plans super-shard ownership at run time — the out-of-core
        structure trigger (cause ``"oocore_replan"``).

        ``config`` replaces the composition's ``OocoreConfig`` (a smaller
        device budget mid-deployment, another hot fraction); omitted, the
        current config is re-planned as it is.  The daemon hook recuts the
        hot set and the cold super-shards under the budget and fills the
        published epoch's ``oocore_plan``.  The cut never changes merged
        values for idempotent monoids, but a sum accumulates super-shards
        in plan order, so like every placement change the epoch is
        published with ``dirty_vertices=None``.  The meta carries
        ``super_shards_before`` / ``_after``, ``hot_cols_before`` /
        ``_after`` and the rebuild's ``seconds``.

        Across ranks every world rank calls it, as it calls
        :meth:`rebalance`: the survivors re-plan together, and an idle
        rank, which holds no plan, publishes the epoch with no plan and
        its counts as None.
        """
        if self._fused_kind != "oocore":
            raise ValueError(
                "oocore_replan() needs an out-of-core composition "
                "(Middleware(oocore=OocoreConfig(...)))")
        t0 = time.perf_counter()
        if config is not None:
            self.oocore = config
        before = self.daemon.oocore_plan
        ep = self.epochs.publish(
            "oocore_replan", mesh=self.upper.mesh,
            partitions=self.partitions, blocksets=self.blocksets,
            dirty_vertices=None,
            meta={"oocore_config": self.oocore,
                  **_plan_counts(before, "before")})
        ep.meta.update(_plan_counts(ep.oocore_plan, "after"))
        ep.meta["seconds"] = time.perf_counter() - t0
        return ep

    # -- dynamic graphs ---------------------------------------------------
    def _rebuild_dirty_blocksets(self, dirty_shards) -> list[int]:
        """Recuts blocks for exactly the shards a mutation touched.

        Clean shards keep their BlockSets (the mutation layer reuses their
        edge arrays by reference, so their blocks are still exact), which
        keeps the daemons' per-blockset tile caches warm.  Block and
        vertex-block sizes stay pinned.  A dirty shard that outgrows the
        pinned vertex-block width widens it for every shard: the JAX
        package rebuilds all shards then, while here the clean shards'
        vertex blocks are only padded to the new width (the same arrays a
        rebuild gives, :func:`~repro_torch.core.blocks.widen_vblocks`),
        with their edge arrays — and so their compacted tiles — kept.  Only
        when the auto block size moved too is every shard rebuilt.
        Across ranks each dirty shard is rebuilt by its owner alone, and the
        ranks agree on whether any grew and on the new width.  Returns the
        shards whose blocks were rebuilt, over every rank."""
        dirty_shards = [int(j) for j in dirty_shards]
        first = self.shards.start
        new_sets = list(self.blocksets)
        grown = []
        for j in dirty_shards:
            if j not in self.shards:
                continue
            try:
                new_sets[j - first] = build_blocks(
                    self.partitions[j], self.block_size,
                    vblock_size=self.vblock_size)
            except ValueError:
                grown.append(j)
        if self._agree(len(grown)):
            if self._resolve_block_size() != self.block_size:
                self._setup_blocks()
                return list(range(self.num_shards))
            for j in grown:
                new_sets[j - first] = build_blocks(self.partitions[j],
                                                   self.block_size)
            # the widest grown shard sets the width every shard pads to,
            # as _setup_blocks would pick it: no unchanged shard exceeds
            # the old width
            self.vblock_size = self._agree(
                max((bs.vblock_size for bs in new_sets), default=0))
            new_sets = [widen_vblocks(bs, self.vblock_size)
                        for bs in new_sets]
        self.blocksets = new_sets
        return dirty_shards

    def apply_mutations(self, batch) -> StructureEpoch:
        """Applies one batched graph mutation and publishes a
        ``"mutation"`` structure epoch.

        The batch (a :class:`~repro_torch.graph.mutation.MutationBatch`,
        or a :class:`~repro_torch.graph.mutation.MutationLog`, frozen
        first) lands in a deterministic order.  Only dirty shards' blocks
        are recut; vertex additions re-bind the daemon and the upper
        system, which recuts every shard's tiles (the tiles were compacted
        against the old vertex count).  The returned epoch's ``meta``
        carries the dirty frontier (touched vertices and their
        out-neighbours) and whether an *incremental* restart from the
        previous fixed point is sound — an idempotent monoid and no
        removals — which :meth:`run_dynamic` consumes.  An empty batch
        publishes nothing and returns the current epoch.
        """
        if isinstance(batch, graph_mutation.MutationLog):
            batch = batch.freeze()
        batch.validate(self.n)
        if batch.empty:
            return self.epochs.epoch
        t0 = time.perf_counter()
        n_old = self.n
        (self.graph, self.partitions, dirty_shards,
         dirty) = graph_mutation.apply_to_partitions(
             self.graph, self.partitions, batch)
        self.n = self.graph.num_vertices
        recut = self._rebuild_dirty_blocksets(dirty_shards)
        if self.n != n_old:
            # per-vertex shapes changed: the daemon and the upper re-bind.
            # Programs whose closures captured the old N (pagerank's
            # (1-d)/n) must be rebuilt by the caller; those deriving
            # everything from init(graph) (sssp, wcc, bfs) work unchanged.
            self.daemon.bind(self.program, self.n, device=self.device)
            self.upper.bind(self.program, self.num_shards,
                            device=self.device)
        incremental = (self.program.monoid.idempotent
                       and not batch.has_removals)
        meta = {
            "incremental": bool(incremental),
            "frontier": graph_mutation.dirty_frontier(self.graph, dirty),
            "edges_added": int(batch.num_added_edges),
            "edges_removed": int(batch.num_removed_edges),
            "vertices_added": int(batch.add_vertices),
            "vertices_removed": int(batch.remove_vertices.size),
            "dirty_count": int(dirty.size),
            "shards_recut": len(recut),
            "shards_clean": self.num_shards - len(recut),
        }
        ep = self.epochs.publish(
            "mutation",
            mesh=self.upper.mesh if self._fused else None,
            partitions=self.partitions, blocksets=self.blocksets,
            dirty_vertices=dirty, meta=meta)
        ep.meta["seconds"] = time.perf_counter() - t0
        return ep

    def run_dynamic(self, batch, *, max_iterations: int | None = None
                    ) -> Result:
        """Applies ``batch`` and restarts the program on the mutated graph
        — incrementally when that is sound, cold otherwise.

        Incremental restart resumes from the previous run's fixed point
        with only the dirty frontier active: for an idempotent monoid and
        an add-only batch the old fixed point is a valid intermediate of
        the new computation, so convergence from it is exact — bit-equal
        to a cold restart, in fewer iterations for small batches.
        Removals or a non-idempotent monoid fall back to a cold restart;
        ``self.last_restart`` records the mode (``"dirty"``, ``"cold"``
        or ``"cold_fallback"``), why, and the iterations.
        """
        prev = self._last_state
        ep = self.apply_mutations(batch)
        meta = ep.meta if ep.cause == "mutation" else {}
        incremental = bool(meta.get("incremental")) and prev is not None
        if incremental:
            if prev.shape[0] < self.n:
                # added vertex ids start at the program's initial state
                state0, _ = self.program.init(self.graph)
                prev = np.concatenate([prev, state0[prev.shape[0]:]],
                                      axis=0)
            prev_state = np.asarray(prev)

            def init(g, _s=prev_state, _i=self.program.init):
                return _s, _i(g)[1]

            res = self.run(max_iterations, init=init,
                           frontier=meta["frontier"])
            mode = "dirty"
        else:
            res = self.run(max_iterations)
            mode = ("cold_fallback"
                    if meta and prev is not None and not meta.get(
                        "incremental") else "cold")
        if incremental:
            reason = ""
        elif prev is None:
            reason = "no previous fixed point"
        elif not self.program.monoid.idempotent:
            reason = "non-idempotent monoid"
        else:
            reason = "batch removes edges/vertices"
        self.last_restart = {
            "mode": mode,
            "incremental": bool(incremental),
            "reason": reason,
            "dirty_count": int(meta.get("dirty_count", 0)),
            "iterations": int(res.iterations),
        }
        return res


def _plan_counts(plan, when: str) -> dict:
    """A plan's group count and hot columns for an epoch's meta (None on
    an idle rank, which holds no plan)."""
    return {f"super_shards_{when}": (None if plan is None
                                     else int(plan.num_super_shards)),
            f"hot_cols_{when}": None if plan is None else int(plan.hot_cols)}


class HostDriveLoop:
    """The per-shard host path.

    Aggregates round-trip through the host every iteration; in exchange
    this loop carries the paper's full inter-iteration machinery — LRU
    boundary caches, lazy-upload byte accounting, candidate apply +
    synchronization skipping — plus per-shard busy-time records feeding
    the Lemma-2 capacity estimator.

    Over a :class:`~repro_torch.dist.sharding.RankMesh` a rank runs its own
    shards: their aggregates, candidate applies and LRU caches.  The ranks
    agree on the skip verdict (the one-process verdict, through one
    ``all_reduce``), gather every shard's updated boundary and query lists
    for the exchange (so the query queue, the uploads and the caches'
    invalidations are the one-process ones), merge through the upper
    system's collectives, and sum each record's per-shard counters and, at
    the end, ``SyncStats``' per-shard counters: every rank returns the
    records and stats one process would.
    """

    def __init__(self, mw: Middleware):
        self.mw = mw
        # active-set size buckets already seen: the first call of a bucket
        # may pay a one-off cost (the kernels' build, allocator growth)
        # inside the busy-time window and must not reach the estimator
        self._seen_buckets: set[int] = set()

    # -- one shard's Gen + per-block Merge ---------------------------------
    def _shard_aggregate(self, j: int, state_j: np.ndarray, aux: np.ndarray,
                         active_j: np.ndarray | None, record: dict):
        """Agent work for shard j → (N,K) aggregate, (N,) counts, and the
        boundary read ids of the blocks that ran (the exchange's query
        set)."""
        mw = self.mw
        bs = mw.blocksets[j - mw.shards.start]
        o = mw.options
        if (mw.program.frontier_driven and o.frontier_block_skipping
                and active_j is not None):
            blk_active = np.any(active_j[bs.gsrc] & bs.emask, axis=1)
            sel = np.nonzero(blk_active)[0]
        else:
            sel = np.arange(bs.num_blocks)
        record["blocks_total"] = record.get("blocks_total", 0) + bs.num_blocks
        record["blocks_run"] = record.get("blocks_run", 0) + int(sel.size)
        if sel.size == 0:
            agg = np.full((mw.n, mw.k), mw.program.monoid.identity,
                          np.float32)
            return agg, np.zeros(mw.n, np.int32), np.empty(0, np.int64)

        # LRU cache accounting for boundary reads (Sec. III-B2).
        read_ids = np.unique(bs.gsrc[sel][bs.emask[sel]])
        boundary_reads = read_ids[mw.partitions[j].boundary_mask[read_ids]]
        rowbytes = 4 * mw.k + 8
        if o.sync_caching:
            cache = mw._caches[j]
            hit = cache.lookup(boundary_reads.astype(np.int64))
            cache.insert(boundary_reads[~hit].astype(np.int64))
            mw.stats.cache_hits += int(hit.sum())
            mw.stats.cache_misses += int((~hit).sum())
            mw.stats.download_bytes_cache += int((~hit).sum()) * rowbytes
        mw.stats.download_bytes_nocache += int(boundary_reads.size) * rowbytes

        bucket = next_pow2(int(sel.size))
        first_seen = bucket not in self._seen_buckets
        self._seen_buckets.add(bucket)
        t_busy = time.perf_counter()
        agg, cnt = mw.daemon.run_blocks(state_j, aux, bs, sel, record)
        busy = time.perf_counter() - t_busy
        entities = int(sel.size) * bs.block_size
        shards = mw.num_shards
        record.setdefault("shard_busy_s", [0.0] * shards)[j] += busy
        record.setdefault("shard_entities", [0] * shards)[j] += entities
        if not first_seen:
            record.setdefault("shard_timed", [0] * shards)[j] = 1
        return agg, cnt, boundary_reads.astype(np.int64)

    _SUMMED = ("blocks_total", "blocks_run", "shard_busy_s",
               "shard_entities", "shard_timed")

    def _sum_record(self, part: dict, rec: dict) -> None:
        """Adds a gather's record ``part`` to ``rec``: its per-shard
        counters summed over the ranks — ``blocks_total``, ``blocks_run``,
        and the S-long ``shard_busy_s`` / ``shard_entities`` (each rank
        fills its slots; present when some shard ran) — and the daemon's
        own entries (lists of this process's blocks) as they are.  The
        shards' busy times then reach the capacity estimator on every rank
        (those timed outside a first call of their size, ``shard_timed``),
        so every rank's ``rebalance()`` sees every shard's."""
        s = self.mw.num_shards
        vec = np.zeros(2 + 3 * s)
        vec[0] = part.get("blocks_total", 0)
        vec[1] = part.get("blocks_run", 0)
        vec[2:2 + s] = part.get("shard_busy_s", 0.0)
        vec[2 + s:2 + 2 * s] = part.get("shard_entities", 0)
        vec[2 + 2 * s:] = part.get("shard_timed", 0)
        vec = self.mw.ranks.all_reduce_host(vec, "sum")
        for j in np.nonzero(vec[2 + 2 * s:])[0]:
            self.mw._estimator.update(int(j), int(vec[2 + s + j]),
                                      float(vec[2 + j]))
        for i, key in enumerate(("blocks_total", "blocks_run")):
            rec[key] = rec.get(key, 0) + int(vec[i])
        if vec[2 + s:2 + 2 * s].any():
            busy = rec.setdefault("shard_busy_s", [0.0] * s)
            ents = rec.setdefault("shard_entities", [0] * s)
            for j in range(s):
                busy[j] += float(vec[2 + j])
                ents[j] += int(vec[2 + s + j])
        for key, value in part.items():
            if key not in self._SUMMED:
                rec.setdefault(key, []).extend(value)

    def run(self, max_iterations: int | None = None, *,
            init=None, frontier=None) -> Result:
        mw = self.mw
        prog = mw.program
        o = mw.options
        own = list(mw.shards)
        mw.upper.reset()
        max_it = max_iterations or prog.max_iterations
        state0, aux = (init or prog.init)(mw.graph)
        states = [state0.copy() for _ in own]
        active0 = (np.ones(mw.n, dtype=bool) if frontier is None
                   else np.asarray(frontier, dtype=bool))
        actives = [active0.copy() for _ in own]
        skip_ok = o.sync_skipping and prog.supports_sync_skipping()
        boundary_masks = [mw.partitions[j].boundary_mask for j in own]
        per_iter: list[dict] = []
        rowbytes = 4 * mw.k + 8
        t0 = time.perf_counter()
        it = 0
        converged = False

        def gather(rec: dict):
            part: dict = {}
            out = [self._shard_aggregate(j, states[i], aux, actives[i], part)
                   for i, j in enumerate(own)]
            self._sum_record(part, rec)
            return out

        pending = mw.model.prologue(gather)

        for it in range(1, max_it + 1):
            rec: dict = {"iteration": it}
            for c in mw._caches:
                c.tick()
            results = mw.model.aggregates(gather, pending, rec)
            pending = None

            aggs = [r[0] for r in results]
            cnts = [r[1] for r in results]
            reads = [r[2] for r in results]

            # Local candidate apply (needed for skip detection).
            new_states, new_actives, updated_ids = [], [], []
            for i in range(len(own)):
                ns, act = mw._apply_fn(states[i], aggs[i], cnts[i] > 0, aux,
                                       it)
                new_states.append(ns)
                new_actives.append(act)
                updated_ids.append(np.nonzero(act)[0])

            skipped = skip_ok and mw.num_shards > 1 and self._can_skip(
                updated_ids, boundary_masks)
            mw.stats.rounds_total += 1
            rec["skipped"] = bool(skipped)

            if skipped:
                mw.stats.rounds_skipped += 1
                states = new_states
                actives = new_actives
            else:
                # Global merge ("upper system synchronization").
                states, actives = self._global_sync(
                    states, aggs, cnts, aux, it,
                    updated_ids, boundary_masks, reads, rowbytes, rec)

            # every shard's count, in one all_reduce
            active = np.zeros(mw.num_shards, np.int64)
            active[mw.shards.start:mw.shards.stop] = [a.sum() for a in actives]
            active = mw.ranks.all_reduce_host(active, "sum")
            rec["active"] = int(active.max())
            per_iter.append(rec)
            if not active.any():
                converged = True
                break
            pending = mw.model.epilogue(gather, rec)

        final = mw.upper.resolve(states)
        self._sum_shard_stats()
        return Result(
            state=final,
            iterations=it,
            converged=converged,
            stats=mw.stats,
            wall_time=time.perf_counter() - t0,
            per_iteration=per_iter,
        )

    def _can_skip(self, updated_ids, boundary_masks) -> bool:
        """The skip verdict: every updated vertex of every shard (over a
        RankMesh, of every rank's shards) is interior."""
        ok = can_skip_sync(updated_ids, boundary_masks)
        return bool(self.mw.ranks.all_reduce_host(np.array([int(ok)]),
                                                  "min")[0])

    _SHARD_STATS = ("cache_hits", "cache_misses", "download_bytes_cache",
                    "download_bytes_nocache")

    def _sum_shard_stats(self) -> None:
        """``SyncStats``' per-shard counters summed over the ranks (the
        round and byte counters of the exchange are the same on every
        rank)."""
        stats = self.mw.stats
        vec = np.array([getattr(stats, f) for f in self._SHARD_STATS],
                       np.int64)
        vec = self.mw.ranks.all_reduce_host(vec, "sum")
        for f, v in zip(self._SHARD_STATS, vec):
            setattr(stats, f, int(v))

    def _global_sync(self, states, aggs, cnts, aux, it,
                     updated_ids, boundary_masks, reads, rowbytes, rec):
        mw = self.mw
        o = mw.options
        # Byte accounting: dense exchange vs lazy upload (Alg. 3).
        mw.stats.dense_bytes += mw.num_shards * mw.n * mw.k * 4
        # The query set is the boundary reads of the blocks that ran.
        queried = list(reads)
        upd_boundary = [
            u[boundary_masks[i][u]].astype(np.int64)
            for i, u in enumerate(updated_ids)
        ]
        # every shard's lists, in shard order, on every rank
        lists = mw.ranks.all_gather_host((upd_boundary, queried))
        upd_boundary = [u for ul, _ in lists for u in ul]
        queried = [q for _, ql in lists for q in ql]
        gqq, uploads = mw.upper.exchange(upd_boundary, queried)
        mw.stats.lazy_bytes += int(sum(u.size for u in uploads)) * rowbytes
        mw.stats.lazy_bytes += int(gqq.size) * 8  # query-queue broadcast
        if o.sync_caching:
            # Invalidate every updated boundary vertex, not just this
            # round's uploads: cached copies are stale the moment it changes.
            changed = np.unique(np.concatenate(
                [u for u in upd_boundary] or [np.empty(0, np.int64)]))
            for c in mw._caches:
                c.invalidate(changed)

        base, agg, cnt = mw.upper.merge(states, aggs, cnts)
        ns, act = mw._apply_fn(base, agg, cnt > 0, aux, it)
        return [ns.copy() for _ in states], [act.copy() for _ in states]


def _device_source_masks(partitions, m: int, n: int) -> np.ndarray:
    """(m, N) bool: which source vertices device g owns edges of (device g
    holds shards g·S/m … (g+1)·S/m − 1).  The async loop delivers a newly
    active source only to the devices that can generate its messages; a
    source no device owns (an isolated vertex) goes to nobody."""
    masks = np.zeros((m, n), dtype=bool)
    cap = len(partitions) // m
    for i in range(m):
        for p in partitions[i * cap:(i + 1) * cap]:
            src = np.asarray(p.src)
            if src.size:
                masks[i, np.unique(src)] = True
    return masks


class _FusedLoopBase:
    """What the device-resident fused drive loops share.

    A subclass defines the carry it threads between iterations
    (:meth:`_init_carry`; element 0 is the vertex state), :meth:`_advance`,
    one iteration on the device, :meth:`_read_extra`, which reads its own
    values from the iteration's fetch, and :meth:`_migrate_carry`, the
    carry re-placed for a kill, join or rebalance epoch.  The base owns the
    rest: placing state, aux and the frontier on the device, the ``init=``
    / ``frontier=`` overrides, the iteration loop, ONE device→host fetch an
    iteration, the per-iteration records and the single final transfer of
    the state — and, between iterations, the structure poll: the
    middleware publishes the due kills, joins, straggler migrations and
    mutation batches as structure epochs, and the loop adopts a new epoch
    by its version (:meth:`_adopt_epoch`), never rebuilding anything
    itself.
    """

    def __init__(self, mw: Middleware):
        self.mw = mw
        self._use_frontier = (mw.program.frontier_driven
                              and mw.options.frontier_block_skipping)
        self._epoch_seen = -1  # the bus version the carry is placed for
        self._placed = None  # the rank mesh the carry is placed for
        self._records: list = []  # the run's per-iteration records

    def _init_carry(self, state, active, active0):
        """The first carry from the placed state and frontier (``active0``
        is the frontier's host copy)."""
        raise NotImplementedError

    def _advance(self, carry, aux, it, stacked):
        """One iteration → ``(carry', flags)``, ``flags`` one small int64
        device tensor ``[done, n_active, *blocks_run (S), *extra]``."""
        raise NotImplementedError

    def _read_extra(self, carry, extra: list):
        """The fetched ``extra`` values → ``(carry', record entries)``."""
        return carry, {}

    def _migrate_carry(self, carry):
        """The carry re-placed for a kill, join or rebalance epoch."""
        raise NotImplementedError

    def _mutate_carry(self, carry, state0, ep):
        """The carry re-placed for a mid-run mutation epoch (the shard axis
        is unchanged; the graph under the run is not).  Incremental: keep
        the state so far and force the dirty frontier active — sound for
        add-only batches under an idempotent monoid, where the current
        state is a valid intermediate of the new computation.  Cold: the
        new graph's initial state with every vertex active — the rest of
        the run IS the cold restart."""
        state, active = carry[0], carry[1]
        dev = self.mw.device
        if ep.meta.get("incremental"):
            return (state, active | torch.as_tensor(ep.meta["frontier"],
                                                    device=dev))
        return (torch.as_tensor(state0, device=dev),
                torch.ones(self.mw.n, dtype=torch.bool, device=dev))

    def _joiner_carry(self, state, active):
        """A rank back from idle: the carry's tensors that
        :meth:`_migrate_carry` overwrites by broadcast, at the current
        graph's shapes."""
        return (state, active)

    def _host_state(self):
        """Host values of the loop a rank back from idle takes over."""
        return None

    def _set_host_state(self, value) -> None:
        pass

    def _adopt_epoch(self, carry, aux, init_fn):
        """Re-places the carry for the epoch the middleware just published
        → ``(carry', aux')``.  A migration keeps the state where it lies
        (``upper.migrate``); a mutation epoch recomputes aux from the
        mutated graph (degrees changed) and goes through
        :meth:`_mutate_carry`.

        Across ranks a migration is a new mesh: a rank back from idle takes
        the records so far and the loop's host values from the upper's
        ``source`` rank, then the carry and aux by broadcast; a rank whose
        devices left the axis takes part in the old group's last
        collectives and goes idle."""
        mw = self.mw
        ep = mw.epochs.epoch
        moved = mw.ranks is not self._placed
        if moved and mw._rank_joined():
            state0, aux0 = init_fn(mw.graph)
            dev = mw.device
            carry = self._joiner_carry(
                torch.as_tensor(state0, device=dev),
                torch.ones(mw.n, dtype=torch.bool, device=dev))
            aux = torch.as_tensor(aux0, device=dev)
        if moved and mw.upper.joined and not mw.ranks.idle:
            records, rounds, host = mw.ranks.broadcast_host(
                (self._records, mw.stats.rounds_total, self._host_state()),
                mw.upper.source)
            self._records[:] = records
            mw.stats.rounds_total = rounds
            self._set_host_state(host)
        if ep.cause != "mutation" or moved:
            carry, aux = self._migrate_carry(carry), mw.upper.migrate(aux)
        if ep.cause == "mutation" and not mw.ranks.idle:
            state0, aux0 = init_fn(mw.graph)
            carry, aux = (self._mutate_carry(carry, state0, ep),
                          torch.as_tensor(aux0, device=mw.device))
        self._placed = mw.ranks
        return carry, aux

    def run(self, max_iterations: int | None = None, *,
            init=None, frontier=None) -> Result:
        mw = self.mw
        prog = mw.program
        mw.upper.reset()
        mw._polled = 0
        max_it = max_iterations or prog.max_iterations
        init_fn = init or prog.init
        state0, aux = init_fn(mw.graph)
        active0 = (np.ones(mw.n, dtype=bool) if frontier is None
                   else np.asarray(frontier, dtype=bool))
        if active0.shape != (mw.n,):
            raise ValueError(f"frontier must have shape ({mw.n},), got "
                             f"{active0.shape}")
        dev = mw.device
        state, aux, active = (torch.as_tensor(a, device=dev)
                              for a in (state0, aux, active0))
        self._placed = mw.ranks
        carry = self._init_carry(state, active, active0)
        self._epoch_seen = mw.epochs.version
        # captured after _init_carry, which may arm the priority buckets
        stacked = mw.daemon.stacked
        blocks_total = 0 if mw.ranks.idle else mw._blocks_total()
        s = mw.num_shards
        self._records = per_iter = []
        t0 = time.perf_counter()
        it = 0
        converged = False

        while it < max_it or mw.ranks.idle:
            if mw.ranks.idle:
                # outside the survivors' group: sit the run out until its
                # end, or until a join brings this rank back
                got = mw._sit_out()
                if isinstance(got, Result):
                    return got
                it, ev = got
            else:
                it += 1
                # The structure check between fused iterations: a device
                # killed (or a batch due) "at iteration k" lands before
                # iteration k runs.  The poll publishes epochs; the loop
                # reacts to the bus VERSION and resumes from the carry — no
                # checkpoint.
                ev = mw._poll_structure(it)
            if mw.epochs.version != self._epoch_seen:
                t_reb = time.perf_counter()
                carry, aux = self._adopt_epoch(carry, aux, init_fn)
                self._epoch_seen = mw.epochs.version
                if mw.ranks.idle:  # this rank's devices left the axis
                    continue
                # after the adoption, which may re-arm the buckets
                stacked = mw.daemon.stacked
                blocks_total = mw._blocks_total()
                reb_s = time.perf_counter() - t_reb
                for r in ev.values():  # charge the rebuild to its trigger
                    if "seconds" in r:
                        r["seconds"] += reb_s
                        break
            carry, flags = self._advance(carry, aux, it, stacked)
            mw.stats.rounds_total += 1
            # the iteration's ONE device→host fetch: every record scalar
            # rides it (each int()/bool() of a tensor would be a sync)
            done, n_active, *rest = flags.tolist()
            shard_blocks = rest[:s]
            carry, extra = self._read_extra(carry, rest[s:])
            rec = {"iteration": it, "fused": True,
                   "blocks_total": blocks_total,
                   "blocks_run": sum(shard_blocks),
                   "shard_blocks_run": shard_blocks, "active": n_active}
            rec.update(ev)
            rec.update(extra)
            per_iter.append(rec)
            if done:
                converged = True
                break

        final = carry[0].cpu().numpy()  # the run's one transfer of the state
        res = Result(
            state=final,
            iterations=it,
            converged=converged,
            stats=mw.stats,
            wall_time=time.perf_counter() - t0,
            per_iteration=per_iter,
        )
        if mw._idle_ranks():
            # the idle ranks replay the polls up to here and return this
            mw._post(("done", mw._polled, res))
        return res


class DriveLoop(_FusedLoopBase):
    """The device-resident fused drive loop (the sharded fast path).

    Each iteration: the daemon's ``run_all_shards`` (gather + Gen +
    segmented Merge + the per-device combine for every shard), the upper
    system's ``merge_partials``, :func:`apply_step` and the convergence
    check, all on the device.  State and frontier stay there between
    iterations; only ``[done, n_active, *blocks_run]`` crosses to the host,
    and the final state crosses once after the loop.

    The merge runs inside every step, so shard replicas never diverge:
    there is no candidate apply, no sync round to skip and no download to
    cache, and ``stats`` carries ``rounds_total`` only.  The
    :class:`HostDriveLoop` keeps the full byte accounting.
    """

    def _init_carry(self, state, active, active0):
        return (state, active)

    def _migrate_carry(self, carry):
        # state and frontier are what every logical device reads: the move
        # is a re-placement, and on one card they already lie there
        return tuple(self.mw.upper.migrate(list(carry)))

    def _advance(self, carry, aux, it, stacked):
        mw = self.mw
        state, active = carry
        partials, counts, blocks_run = mw.daemon.run_all_shards(
            state, aux, active if self._use_frontier else None,
            stacked=stacked)
        agg, cnt = mw.upper.merge_partials(partials, counts)
        # base == state: replicas are merged every step, never diverge
        new_state, new_active = apply_step(mw.program, state, agg, cnt > 0,
                                           aux, it)
        n_active = new_active.sum()
        # every shard's count: this process's slots, one all_reduce
        every = blocks_run.new_zeros(mw.num_shards)
        every[mw.shards.start:mw.shards.stop] = blocks_run
        blocks_run = mw.ranks.all_reduce(every, "sum")
        flags = torch.cat([torch.stack([(n_active == 0).long(), n_active]),
                           blocks_run.long()])
        return (new_state, new_active), flags


class OocoreDriveLoop(_FusedLoopBase):
    """The out-of-core fused drive loop: super-shards streamed onto the card.

    Each iteration runs the same shard body as :class:`DriveLoop`, once per
    column group instead of once: first over the device-resident hot set,
    then over each cold super-shard as it arrives from pinned host memory.
    Per-device partials accumulate across groups with ``monoid.combine``
    into identity-filled (m, N, K) / (m, N) accumulators, and the upper's
    ``merge_partials``, :func:`apply_step` and the convergence check run
    once at the end — so the state trajectory is the resident loop's, bit
    for bit for idempotent monoids.

    With ``prefetch`` on, super-shard i + 1 copies on a side CUDA stream
    while super-shard i computes (:class:`~repro_torch.oocore.AsyncUploader`:
    two device slots, so at most two cold groups live), wrapping around so the next iteration's
    first group copies during this iteration's tail.  For frontier-driven
    programs the scheduler skips a cold group none of whose live sources is
    active — its partial is exactly the identity — upload and compute both.
    The verdict for iteration t + 1 is formed on the card at the end of
    step t from the new frontier (``super_shard_activity``) and rides the
    step's one fetch, so the (N,) frontier never crosses to the host; the
    first iteration's comes from the frontier's host copy.  After a
    structure epoch re-cut the groups, the next iteration takes every
    group (a group without an active source adds the identity), and the
    verdicts resume from its fetch.  Without prefetch every group is
    copied on the compute stream and computed in turn, and none is
    skipped.

    The fetch also carries the hot hits and cold misses (active tiles or
    blocks served from the hot set and from streamed groups).

    Over a :class:`~repro_torch.dist.sharding.RankMesh` a rank runs its own
    hot set and its own columns of each group into (local, N, K)
    accumulators, and ``merge_partials``' collectives run once an
    iteration, after the group loop.  A rank skips a group none of whose
    columns *it* holds has an active source, so a group one process skips
    is skipped on every rank, and a rank may skip more.  The blocks run
    and the hit counts ride one SUM ``all_reduce`` an iteration: a record's
    ``hot_hits`` and ``cold_misses`` are the world's, its ``skipped``,
    copies and spans the rank's own.  Each rank has its own uploader (a
    side stream and two slots) and pins only its own cold columns.

    Each record gets ``oocore``: ``super_shards``, ``hot_cols``, ``prefetch``,
    ``seconds``, ``transfer_s`` (the copies, event-timed, a dropped
    wrap-around guess's included), ``wait_s`` (how long the compute stream
    stalled on them), ``hidden_s``,
    ``overlap_efficiency``, ``skipped``, ``hot_hits``, ``cold_misses`` and
    ``hot_hit_rate``; ``Middleware.oocore_stats`` sums them over every run,
    with ``uploads``, ``upload_bytes`` and ``max_live_groups``.
    """

    def __init__(self, mw: Middleware):
        super().__init__(mw)
        self._uploader = None
        self._side = None  # the copy stream, one for every uploader
        self._acc0 = None
        self._prefetching = False
        self._activity = None  # next iteration's group verdicts, or None
        self._step_info = None  # this iteration's spans, read after its fetch

    def _arm(self):
        """The loop's view of the current binding: identity accumulators at
        the axis length and a fresh uploader, warmed with group 0.  Called
        when a run starts and when an epoch is adopted."""
        mw = self.mw
        daemon = mw.daemon
        dev = mw.device
        # the old binding's slots and accumulators go before the new ones
        # are allocated
        if self._uploader is not None:
            self._uploader.close()
        self._uploader = self._acc0 = None
        self._acc0 = (
            torch.full((daemon.m, mw.n, mw.k), mw.program.monoid.identity,
                       dtype=torch.float32, device=dev),
            torch.zeros((daemon.m, mw.n), dtype=torch.int32, device=dev))
        num_ss = daemon.num_super_shards
        self._prefetching = bool(mw.oocore.prefetch) and num_ss > 0
        if num_ss:
            if (self._side is None and self._prefetching
                    and dev.type == "cuda"):
                self._side = torch.cuda.Stream(device=dev)
            self._uploader = AsyncUploader(daemon.upload_super_shard, dev,
                                           prefetch=self._prefetching,
                                           stream=self._side)
            self._uploader.request(0)  # warm the pipe before iteration 1
        self._activity = None

    def _init_carry(self, state, active, active0):
        self._arm()
        if self._prefetching and self._use_frontier:
            daemon = self.mw.daemon
            self._activity = [daemon.super_shard_active(p, active0)
                              for p in range(daemon.num_super_shards)]
        return (state, active)

    def _migrate_carry(self, carry):
        # state and frontier lie where every logical device reads them; the
        # groups were re-cut, so the loop re-arms for the new binding
        carry = tuple(self.mw.upper.migrate(list(carry)))
        self._arm()
        return carry

    def _mutate_carry(self, carry, state0, ep):
        carry = super()._mutate_carry(carry, state0, ep)
        self._arm()
        return carry

    def _advance(self, carry, aux, it, stacked):
        # ``stacked`` is the resident stack of the other fused loops, unused
        # here: columns come from the hot set and the host stream
        mw = self.mw
        daemon, upper, prog = mw.daemon, mw.upper, mw.program
        monoid = prog.monoid
        state, active = carry
        act = active if self._use_frontier else None
        t_iter = time.perf_counter()
        acc_p, acc_c = self._acc0
        num_ss = daemon.num_super_shards
        hot_br = cold_br = None
        if daemon.hot_stacked is not None:
            p, c, hot_br = daemon.run_all_shards(state, aux, act,
                                                 stacked=daemon.hot_stacked)
            acc_p, acc_c = monoid.combine(acc_p, p), acc_c + c
        todo = list(range(num_ss))
        if self._activity is not None:
            todo = [g for g in todo if self._activity[g]]
        up = self._uploader
        spans = []
        for i, g in enumerate(todo):
            group, transfer, wait = up.take(g)
            spans.append((transfer, wait))
            if self._prefetching:
                # double buffer: the next group copies while this one
                # computes; the wrap-around is iteration it + 1's first
                up.request(todo[(i + 1) % len(todo)])
            p, c, br = daemon.run_all_shards(state, aux, act, stacked=group)
            acc_p, acc_c = monoid.combine(acc_p, p), acc_c + c
            cold_br = br if cold_br is None else cold_br + br
            del group
            up.release(g)
        # copies dropped as stale guesses ran on the copy stream all the
        # same: a wait that sat behind one is matched by its transfer
        stale = up.pop_stale() if up is not None else []
        agg, cnt = upper.merge_partials(acc_p, acc_c)
        new_state, new_active = apply_step(prog, state, agg, cnt > 0, aux, it)
        n_active = new_active.sum()
        zero = torch.zeros(daemon.num_shards, dtype=torch.int32,
                           device=mw.device)
        hot_br = zero if hot_br is None else hot_br
        cold_br = zero if cold_br is None else cold_br
        nxt = (daemon.super_shard_activity(new_active)
               if self._prefetching and self._use_frontier
               else zero[:0].bool())
        # every shard's blocks run (this process's slots) and the hot hits
        # and cold misses, in one SUM all_reduce; the group verdicts are
        # this rank's own
        s = mw.num_shards
        world = torch.zeros(s + 2, dtype=torch.long, device=mw.device)
        world[mw.shards.start:mw.shards.stop] = hot_br + cold_br
        world[s] = hot_br.sum()
        world[s + 1] = cold_br.sum()
        world = mw.ranks.all_reduce(world, "sum")
        flags = torch.cat([
            torch.stack([(n_active == 0).long(), n_active]), world,
            nxt.long()])
        self._step_info = (t_iter, num_ss, len(todo), spans, stale)
        return (new_state, new_active), flags

    def _read_extra(self, carry, extra):
        mw = self.mw
        daemon = mw.daemon
        t_iter, num_ss, uploads, spans, stale = self._step_info
        hot_hits, misses = extra[:2]
        if self._prefetching and self._use_frontier:
            self._activity = [bool(x) for x in extra[2:2 + num_ss]]
        # the copies' events: the compute stream has passed them all
        transfer_s = (sum(t.seconds() for t, _ in spans)
                      + sum(t.seconds() for t in stale))
        wait_s = sum(w.seconds() for _, w in spans)
        iter_s = time.perf_counter() - t_iter
        skipped = num_ss - uploads
        total = hot_hits + misses
        # unclamped: a wait longer than its transfers would read below 0
        overlap = 1.0 if transfer_s <= 0 else 1.0 - wait_s / transfer_s
        rec = {"super_shards": num_ss,
               "hot_cols": int(daemon.oocore_plan.hot_cols),
               "prefetch": self._prefetching,
               "seconds": iter_s,
               "transfer_s": transfer_s, "wait_s": wait_s,
               "hidden_s": transfer_s - wait_s,
               "overlap_efficiency": overlap,
               "skipped": skipped,
               "hot_hits": hot_hits, "cold_misses": misses,
               "hot_hit_rate": hot_hits / total if total else 0.0}
        st = mw.oocore_stats
        if not st:
            st.update(iterations=0, transfer_s=0.0, wait_s=0.0,
                      hidden_s=0.0, hot_hits=0, cold_misses=0, uploads=0,
                      upload_bytes=0, skipped=0, super_shards=num_ss,
                      prefetch=self._prefetching, max_live_groups=0)
        st["iterations"] += 1
        st["transfer_s"] += transfer_s
        st["wait_s"] += wait_s
        st["hidden_s"] += transfer_s - wait_s
        st["hot_hits"] += hot_hits
        st["cold_misses"] += misses
        st["uploads"] += uploads
        st["upload_bytes"] += uploads * daemon.super_shard_nbytes
        st["skipped"] += skipped
        seen = st["hot_hits"] + st["cold_misses"]
        st["hot_hit_rate"] = st["hot_hits"] / seen if seen else 0.0
        st["overlap_efficiency"] = (
            1.0 if st["transfer_s"] <= 0
            else 1.0 - st["wait_s"] / st["transfer_s"])
        if self._uploader is not None:
            st["max_live_groups"] = max(st["max_live_groups"],
                                        self._uploader.max_live_groups)
        return carry, {"oocore": rec}


class AsyncDriveLoop(_FusedLoopBase):
    """The device-resident fused loop of the asynchronous priority model.

    Like :class:`DriveLoop`, one step an iteration on the device, but the
    step also carries the model's scheduling state there:

    * **held partials and counts** (m, N, K) / (m, N) — what each logical
      device last *shipped*.  The upper's ``merge_partials_async`` decides
      per device whether this round's merge consumes its fresh partial or
      the held one: a device whose contribution moved less than the
      threshold holds (its consumers keep reading the stale aggregate),
      the rest refresh.
    * **frontier backlog** (m, N) — for frontier-driven programs, the
      sources that became active while a device held, each delivered only
      to the devices owning its edges (:func:`_device_source_masks`).  A
      device runs on its backlog row as its private frontier, so a message
      suppressed during a hold is regenerated from the source's current
      state on refresh: no update is lost, and the fixed point is exact.
    * **theta** — the priority threshold, a float32 on the device: it
      starts at ``theta0``, decays by ``decay`` every iteration and drops
      to 0 the moment the frontier drains, so the tail of the run is
      barriered.

    The cadence is split so a hold is *free*:

    * **predict**: a device runs Gen only if its estimated priority —
      its last committed priority, raised by the largest residual among
      its backlogged sources — can clear theta (or theta is at the
      floor).  The estimate can only over-estimate the commit priority, so
      a predicted hold is safe; a mispredict costs one hold iteration.
      Every input of iteration t + 1's prediction is known at the end of
      step t, so the step computes that verdict and whether each backlog
      row holds a source, and both ride the step's one fetch: iteration
      t + 1's ``run_all_shards(run_mask=)`` gets them as host values and
      launches work only for the devices that execute, with no extra
      sync.  Iteration 1's verdict is formed on the host (no committed
      priority yet: every device may run).
    * **commit**: ``merge_partials_async`` decides the refresh on the
      fresh partials that were produced; only committed priorities feed
      the next prediction.

    A daemon without :class:`~repro_torch.plug.protocols.MaskCapableDaemon`,
    or an upper whose ``merge_partials_async`` takes no ``run_mask``, gets
    the run-everything cadence (every device runs every iteration).

    Convergence is reported only on an iteration where the frontier is
    empty, every device refreshed and no backlog is pending.  The records
    add ``async``, ``refreshed``, ``devices``, ``theta``, ``gen_run`` (the
    device bodies run), ``gen_skipped`` and ``run_mask`` to the base keys.

    A migration or a mutation restarts the scheduling state at the new
    axis length (:meth:`_migrate_carry`, :meth:`_mutate_carry`): held
    partials at the identity, so the next merge is one barriered step;
    the union of the backlogs, formed on the card, goes to each source's
    new owner; θ carries over; every device runs the next iteration.
    """

    def __init__(self, mw: Middleware):
        super().__init__(mw)
        self.m = mw.upper.m
        self.local, self.lo = mw.daemon.m, mw.ranks.offset
        self._maskable = (
            isinstance(mw.daemon, MaskCapableDaemon)
            and "run_mask" in inspect.signature(
                mw.upper.merge_partials_async).parameters)
        # the model's constants as float32 values, theta's own type: the
        # products and comparisons round as the JAX package's float32 ones
        self._decay = float(np.float32(mw.model.decay))
        self._floor = float(np.float32(mw.model.floor))
        self._src_masks = None
        self._theta_host = float(np.float32(mw.model.theta0))

    def _arm(self):
        """Derives the loop's view of the structure: m (the world's axis),
        this process's ``local`` devices from the ``lo``-th, the priority
        buckets (``bind_shards`` re-stacks without them) and the source
        masks of this process's devices.  Called when a run starts and when
        an epoch is adopted.  Returns the masks' host copy, or None."""
        mw = self.mw
        model = mw.model
        self.m = mw.upper.m
        self.local, self.lo = mw.daemon.m, mw.ranks.offset
        self._src_masks = masks = None
        if self._maskable:
            mw.daemon.configure_buckets(
                int(getattr(model, "bucket_k", 0) or 0),
                int(getattr(model, "bucket_cap", 32) or 32))
            if self._use_frontier:
                masks = self._own_masks()
                self._src_masks = torch.as_tensor(masks, device=mw.device)
        return masks

    def _own_masks(self) -> np.ndarray:
        """(local, N) bool: the sources each of this process's devices owns
        edges of."""
        mw = self.mw
        return _device_source_masks([mw.partitions[j] for j in mw.shards],
                                    self.local, mw.n)

    def _owner_masks(self):
        """(local, N) bool on the device: the sources each of this
        process's devices owns edges of (built here when the free hold did
        not build them)."""
        if self._src_masks is not None:
            return self._src_masks
        return torch.as_tensor(self._own_masks(), device=self.mw.device)

    def _world(self, flags):
        """(local,) bools of this process's devices, a host list or a
        device tensor → the (m,) list of every device's, in axis order:
        one host ``all_reduce``, or one device ``all_reduce`` and its fetch
        (on one process only the fetch)."""
        m, lo, ranks = self.m, self.lo, self.mw.ranks
        if isinstance(flags, torch.Tensor):
            vec = torch.zeros(m, dtype=torch.int32, device=flags.device)
            vec[lo:lo + self.local] = flags
            return [bool(x) for x in ranks.all_reduce(vec, "sum").tolist()]
        vec = np.zeros(m, dtype=np.int64)
        vec[lo:lo + self.local] = flags
        return [bool(x) for x in ranks.all_reduce_host(vec, "sum")]

    def _schedule(self, state, backlog, theta, theta_host, rows):
        """A carry with the scheduling state restarted: held partials at
        the identity and zero counts (the first fresh partials score the
        highest priority wherever a message is), ``prev_pri`` at float max
        (no committed priority: every device may run) and a zero residual
        (nothing has moved).  The first iteration's predict half is formed
        on the host from θ's host value; ``rows`` says which backlog rows
        hold a source, over the world's m devices, as the run mask does."""
        mw = self.mw
        local, n, dev = self.local, mw.n, mw.device
        held_p = torch.full((local, n, mw.k), mw.program.monoid.identity,
                            dtype=torch.float32, device=dev)
        held_c = torch.zeros((local, n), dtype=torch.int32, device=dev)
        fmax = np.finfo(np.float32).max
        prev_pri = torch.full((local,), float(fmax), dtype=torch.float32,
                              device=dev)
        residual = torch.zeros(n, dtype=torch.float32, device=dev)
        th = np.float32(theta_host)
        run = [bool((fmax >= th) | (th <= np.float32(self._floor)))
               if self._maskable else True] * self.m
        run_dev = torch.as_tensor(np.array(run[self.lo:self.lo + local],
                                           dtype=bool), device=dev)
        return (state, backlog, held_p, held_c, theta, prev_pri, residual,
                run_dev, run, rows)

    def _init_carry(self, state, active, active0):
        mw = self.mw
        masks = self._arm()
        theta0 = np.float32(mw.model.theta0)
        theta = torch.full((), float(theta0), dtype=torch.float32,
                           device=mw.device)
        self._theta_host = float(theta0)
        backlog, rows = None, [True] * self.m
        if self._use_frontier:
            host = np.broadcast_to(active0[None, :], (self.local, mw.n))
            if masks is not None:
                host = host & masks
            backlog = torch.as_tensor(np.ascontiguousarray(host),
                                      device=mw.device)
            rows = self._world(host.any(axis=1))
        return self._schedule(state, backlog, theta, self._theta_host, rows)

    def _joiner_carry(self, state, active):
        # _migrate_carry reads the state, the backlog (a rank back from
        # idle holds no row) and θ
        mw = self.mw
        backlog = (torch.zeros((0, mw.n), dtype=torch.bool, device=mw.device)
                   if self._use_frontier else None)
        theta = torch.zeros((), dtype=torch.float32, device=mw.device)
        return (state, backlog, None, None, theta)

    def _host_state(self):
        return self._theta_host

    def _set_host_state(self, value) -> None:
        self._theta_host = value

    def _union(self, backlog, mesh):
        """Every backlog row of ``mesh``'s devices (a dead device's
        included) folded into one (N,) int32, formed on the card: this
        process's rows, then a MAX over ``mesh``'s group (a rank outside
        it adds nothing)."""
        merged = backlog.any(dim=0).to(torch.int32)
        if not mesh.idle:
            mesh.all_reduce(merged, "max")
        return merged

    def _redeliver(self, merged, extra=None):
        """``merged`` sources (:meth:`_union`), with ``extra`` ones,
        delivered only to the devices owning their edges after the rebuild
        — this process's rows, formed on the card.  Re-delivery may
        recompute work but never loses an update.  Returns them and the
        world's non-empty rows (one (m,) fetch, which only the free hold
        reads)."""
        merged = merged.bool()
        if extra is not None:
            merged = merged | extra
        backlog = merged[None, :] & self._owner_masks()
        rows = (self._world(backlog.any(dim=1)) if self._maskable
                else [True] * self.m)
        return backlog, rows

    def _migrate_carry(self, carry):
        """Re-placement of the async carry for a new axis length m′.  The
        state stays where it lies (``upper.migrate``).  The scheduling
        state restarts for m′ (:meth:`_schedule`): held partials at the
        identity make the next merge consume every device's fresh partial,
        so nothing a device was holding is lost, and ``prev_pri`` at float
        max makes every survivor run before it may hold again.  The union
        of the old backlogs, over the old group, goes to each source's new
        owner; θ carries over (to a rank back from idle, by broadcast with
        the state and the union)."""
        mw = self.mw
        state, backlog, theta = carry[0], carry[1], carry[4]
        merged = None
        if backlog is not None:
            merged = self._union(backlog, self._placed)
        state, merged, theta = mw.upper.migrate((state, merged, theta))
        if mw.ranks.idle:
            return carry
        self._arm()
        rows = [True] * self.m
        if merged is not None:
            backlog, rows = self._redeliver(merged)
        return self._schedule(state, backlog, theta, self._theta_host, rows)

    def _mutate_carry(self, carry, state0, ep):
        """A mid-run mutation under the async model.  Held partials were
        computed on the old graph and must never be consumed, so the
        scheduling state restarts (:meth:`_schedule`).  Incremental: state
        and θ carry over, and the dirty frontier joins the union of the
        backlogs, delivered to each source's owner in the mutated graph's
        shards.  Cold: the full async reset on the new graph, as a run
        starts."""
        mw = self.mw
        if not ep.meta.get("incremental"):
            ones = np.ones(mw.n, dtype=bool)
            return self._init_carry(
                torch.as_tensor(state0, device=mw.device),
                torch.as_tensor(ones, device=mw.device), ones)
        state, backlog, theta = carry[0], carry[1], carry[4]
        self._arm()
        rows = [True] * self.m
        if backlog is not None:
            backlog, rows = self._redeliver(
                self._union(backlog, mw.ranks),
                torch.as_tensor(ep.meta["frontier"], device=mw.device))
        return self._schedule(state, backlog, theta, self._theta_host, rows)

    def _advance(self, carry, aux, it, stacked):
        mw = self.mw
        daemon, upper, prog = mw.daemon, mw.upper, mw.program
        (state, backlog, held_p, held_c, theta, prev_pri, residual, run_dev,
         run, rows) = carry
        lo, hi = self.lo, self.lo + self.local
        act = backlog if self._use_frontier else None
        if self._maskable:
            fresh_p, fresh_c, blocks_run = daemon.run_all_shards(
                state, aux, act, run_mask=run[lo:hi], residual=residual,
                stacked=stacked, live_rows=rows[lo:hi])
            (agg, cnt, held_p, held_c, refreshed,
             pri) = upper.merge_partials_async(
                fresh_p, fresh_c, held_p, held_c, theta, self._floor,
                run_dev)
            # only committed priorities feed the next prediction: a held
            # device's identity output says nothing new
            prev_pri = torch.where(run_dev, pri, prev_pri)
        else:
            fresh_p, fresh_c, blocks_run = daemon.run_all_shards(
                state, aux, act, stacked=stacked)
            out = upper.merge_partials_async(
                fresh_p, fresh_c, held_p, held_c, theta, self._floor)
            agg, cnt, held_p, held_c, refreshed = out[:5]
            if len(out) > 5:
                prev_pri = torch.where(refreshed, out[5], prev_pri)
        if self._use_frontier:
            backlog = backlog & ~refreshed[:, None]
        new_state, new_active = apply_step(prog, state, agg, cnt > 0, aux, it)
        # the per-vertex residual of this Apply: the next prediction's
        # signal and the buckets' score (NaN from non-finite identities
        # counts 0, ±inf clamps to float32 max)
        residual = torch.nan_to_num((new_state - state).abs().amax(dim=1),
                                    nan=0.0)
        n_active = new_active.sum()
        # the threshold decays every iteration and drops to 0 the moment
        # the frontier drains: convergence is certified on fresh data
        theta = torch.where(n_active == 0, torch.zeros_like(theta),
                            theta * self._decay)
        # iteration t + 1's predict half, from this step's results
        if self._use_frontier:
            new_work = new_active[None, :]
            if self._src_masks is not None:
                new_work = new_work & self._src_masks
            backlog = backlog | new_work
        run_next = rows_next = torch.ones_like(refreshed)
        if self._maskable:
            est = prev_pri
            if self._use_frontier:
                est = torch.maximum(est, torch.where(
                    backlog, residual[None, :], 0.0).amax(dim=1))
                rows_next = backlog.any(dim=1)
            run_next = (est >= theta) | (theta <= self._floor)
            run_dev = run_next
        # the world's view in one small all_reduce: every shard's blocks
        # run, every device's refresh, verdict and backlog flag, and
        # whether any backlog is left — each process fills its own slots
        s, m = mw.num_shards, self.m
        every = torch.zeros(s + 3 * m + 1, dtype=torch.int32,
                            device=state.device)
        every[mw.shards.start:mw.shards.stop] = blocks_run
        every[s + lo:s + hi] = refreshed
        every[s + m + lo:s + m + hi] = run_next
        every[s + 2 * m + lo:s + 2 * m + hi] = rows_next
        if self._use_frontier:
            every[-1] = backlog.any()
        every = mw.ranks.all_reduce(every, "sum").long()
        n_refreshed = every[s:s + m].sum()
        done = (n_active == 0) & (n_refreshed == m) & (every[-1] == 0)
        flags = torch.cat([
            torch.stack([done.long(), n_active]), every[:s],
            torch.stack([n_refreshed, theta.view(torch.int32).long()]),
            every[s + m:s + 3 * m]])
        return (new_state, backlog, held_p, held_c, theta, prev_pri,
                residual, run_dev, run, rows), flags

    def _read_extra(self, carry, extra):
        m = self.m
        n_refreshed, theta_bits = extra[:2]
        run, rows = carry[8], carry[9]
        executed = ([r and a for r, a in zip(run, rows)]
                    if self._use_frontier else run)
        gen_run = sum(executed)
        self._theta_host = np.int32(theta_bits).view(np.float32).item()
        rec = {"async": True, "refreshed": n_refreshed, "devices": m,
               "theta": self._theta_host,
               "gen_run": gen_run, "gen_skipped": m - gen_run,
               "run_mask": run}
        run_next = [bool(x) for x in extra[2:2 + m]]
        rows_next = [bool(x) for x in extra[2 + m:2 + 2 * m]]
        return carry[:8] + (run_next, rows_next), rec
