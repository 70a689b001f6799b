"""The middleware: agents + drive loops composed from the three protocols,
as in the JAX package's ``plug/middleware.py``.

``Middleware`` owns what the paper's *agent* role owns — per-shard host
state (vertex table replicas, LRU boundary caches, block sets, byte
accounting) and the iteration drive loop — and delegates device compute to
the :class:`~repro_torch.plug.protocols.Daemon`, partitioning / exchange /
global merge to the :class:`~repro_torch.plug.protocols.UpperSystem`, and
Gen/Merge/Apply ordering to the
:class:`~repro_torch.plug.protocols.ComputationModel`.

Three drive loops implement the iteration:

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

Out-of-core, elasticity and dynamic graphs raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.balance import CapacityEstimator, lemma2_fractions
from repro_torch.core.blocks import build_blocks
from repro_torch.core.pow2 import next_pow2
from repro_torch.core.sync import LRUVertexCache, SyncStats, can_skip_sync
from repro_torch.core.template import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.graph.structure import EdgePartition, Graph
from repro_torch.plug.computation import BSP, GAS, AsyncModel, get_model
from repro_torch.plug.daemons import get_daemon
from repro_torch.plug.protocols import (DevicePartialUpper,
                                        MaskCapableDaemon, PlugOptions,
                                        PriorityAsyncModel, Result,
                                        ShardCapableDaemon, not_ported_error)
from repro_torch.plug.uppers import get_upper_system

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
    """MSGApply on tensors, where they lie → ``(new_state, active)``; both
    drive loops apply through it."""
    # Vertices with no message keep identity-merged values; msg_apply
    # implementations treat identity correctly (min/max) or use has_msg.
    merged = torch.where(has_msg[:, None], merged,
                         torch.full_like(merged, program.monoid.identity))
    return program.msg_apply(state, merged, has_msg[:, None], aux, it)


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


class Middleware:
    """Drives a VertexProgram through pluggable components.

    Args:
      graph, program: the workload.
      daemon: accelerator backend — a registry name (``"reference"``,
        ``"cuda"``, ``"sharded"``, ``"blocked"``, ``"pipelined"``,
        ``"naive"``, …) or an unbound Daemon instance.
      upper: upper system — ``"host"`` or an instance.
      model: computation model — ``"bsp"`` / ``"gas"`` or an instance.
      partitions: explicit edge partitions; defaults to the upper
        system's partitioner over ``num_shards``.
      capacities: per-shard per-entity costs c_j; shard sizes follow
        Lemma 2.  Ignored when explicit ``partitions`` are given.
      options: :class:`~repro_torch.plug.protocols.PlugOptions`.
      device: where the daemon and MSGApply run; ``"cuda"`` (the
        default) raises on a machine without a GPU.
      monitor, failures, mutations, oocore: the fused loop's elastic,
        dynamic-graph and out-of-core options — not ported yet; passing
        one raises ``NotImplementedError``.

    With a shard-capable daemon (``daemon="sharded"``) and a device-partial
    upper system (``upper="mesh"``), ``run`` drives the fused
    :class:`DriveLoop` for a BSP/GAS model and the fused
    :class:`AsyncDriveLoop` for ``AsyncModel``; otherwise the
    :class:`HostDriveLoop`.
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
        monitor=None,
        failures=None,
        mutations=None,
        oocore=None,
        options: PlugOptions | None = None,
        device="cuda",
    ):
        for name, value, item in (("monitor=", monitor, 9),
                                  ("failures=", failures, 9),
                                  ("mutations=", mutations, 10),
                                  ("oocore=", oocore, 11)):
            if value is not None:
                raise not_ported_error(name, item)
        self.device = resolve_device(device)
        self.graph = graph
        self.program = program
        self.options = options or PlugOptions()
        self.daemon = get_daemon(daemon) if isinstance(daemon, str) else daemon
        self.upper = (get_upper_system(upper) if isinstance(upper, str)
                      else upper)
        self.model = get_model(model) if isinstance(model, str) else model

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
        self.n = graph.num_vertices
        self.k = program.state_width
        self._setup_blocks()

        self.daemon.bind(program, self.n, device=self.device)
        self.upper.bind(program, self.num_shards)
        self._apply_fn = make_apply_fn(program, self.device)
        self.stats = SyncStats()
        self._caches: list[LRUVertexCache] = []  # created per-run by run()
        self._estimator = CapacityEstimator(self.num_shards)
        self._fused_kind = self._detect_fused()
        self._fused = self._fused_kind is not None
        if self._fused:
            self.daemon.bind_shards(self.blocksets, mesh=self.upper.mesh,
                                    axis=self.upper.axis)
        self._loop = {"bsp": DriveLoop, "async": AsyncDriveLoop,
                      None: HostDriveLoop}[self._fused_kind](self)

    # -- setup ------------------------------------------------------------
    def _resolve_block_size(self) -> int:
        o = self.options
        if o.block_size == "auto":
            d = max(1, max(p.num_edges for p in self.partitions))
            best_b, _ = pl.optimal_integer_blocks(d, o.k1, o.k2, o.k3, o.a)
            return int(min(max(best_b, 64), 1 << 16))
        return int(o.block_size)

    def _setup_blocks(self) -> None:
        b = self._resolve_block_size()
        self.block_size = b
        self.blocksets = [build_blocks(p, b) for p in self.partitions]
        # One vertex-block width for all shards → one launch shape.
        vb = max(bs.vblock_size for bs in self.blocksets)
        self.blocksets = [build_blocks(p, b, vblock_size=vb)
                          for p in self.partitions]
        self.vblock_size = vb

    def _detect_fused(self) -> str | None:
        """Which fused device-resident loop this composition gets, if any.
        Both need a shard-capable daemon and an upper system that merges
        device partials over an exact wire; the model then picks the step:
        BSP/GAS share the barriered one (``"bsp"``), a priority/async model
        whose upper also has ``merge_partials_async`` gets the async one
        (``"async"``), and anything else gets None (the host loop, which
        drives the model's hooks)."""
        caps = (isinstance(self.daemon, ShardCapableDaemon)
                and isinstance(self.upper, DevicePartialUpper)
                and getattr(self.upper, "wire", "exact") == "exact")
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
        overrides the initial active mask (default: every vertex).
        """
        # Fresh per-run accounting: stats and LRU caches reset at loop entry.
        self.stats = SyncStats()
        self._caches = [
            LRUVertexCache(self.options.cache_capacity)
            for _ in range(self.num_shards)
        ]
        return self._loop.run(max_iterations, init=init, frontier=frontier)

    # -- later slices -----------------------------------------------------
    def migrate(self, *, killed=(), stragglers=(), joined=()) -> dict:
        raise not_ported_error("Middleware.migrate", 9)

    def rebalance(self, capacities=None) -> np.ndarray:
        raise not_ported_error("Middleware.rebalance", 9)

    def apply_mutations(self, batch):
        raise not_ported_error("Middleware.apply_mutations", 10)

    def run_dynamic(self, batch, *, max_iterations: int | None = None):
        raise not_ported_error("Middleware.run_dynamic", 10)


class HostDriveLoop:
    """The per-shard host path.

    Aggregates round-trip through the host every iteration; in exchange
    this loop carries the paper's full inter-iteration machinery — LRU
    boundary caches, lazy-upload byte accounting, candidate apply +
    synchronization skipping — plus per-shard busy-time records feeding
    the Lemma-2 capacity estimator.
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
        bs = mw.blocksets[j]
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
            mw._estimator.update(j, entities, busy)
        return agg, cnt, boundary_reads.astype(np.int64)

    def run(self, max_iterations: int | None = None, *,
            init=None, frontier=None) -> Result:
        mw = self.mw
        prog = mw.program
        o = mw.options
        mw.upper.reset()
        max_it = max_iterations or prog.max_iterations
        state0, aux = (init or prog.init)(mw.graph)
        states = [state0.copy() for _ in range(mw.num_shards)]
        active0 = (np.ones(mw.n, dtype=bool) if frontier is None
                   else np.asarray(frontier, dtype=bool))
        actives = [active0.copy() for _ in range(mw.num_shards)]
        skip_ok = o.sync_skipping and prog.supports_sync_skipping()
        per_iter: list[dict] = []
        rowbytes = 4 * mw.k + 8
        t0 = time.perf_counter()
        it = 0
        converged = False

        def gather(rec: dict):
            return [
                self._shard_aggregate(j, states[j], aux, actives[j], rec)
                for j in range(mw.num_shards)
            ]

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
            for j in range(mw.num_shards):
                ns, act = mw._apply_fn(states[j], aggs[j], cnts[j] > 0, aux,
                                       it)
                new_states.append(ns)
                new_actives.append(act)
                updated_ids.append(np.nonzero(act)[0])

            boundary_masks = [p.boundary_mask for p in mw.partitions]
            skipped = skip_ok and mw.num_shards > 1 and can_skip_sync(
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

            rec["active"] = int(np.max([a.sum() for a in actives]))
            per_iter.append(rec)
            if all(a.sum() == 0 for a in actives):
                converged = True
                break
            pending = mw.model.epilogue(gather, rec)

        final = mw.upper.resolve(states)
        return Result(
            state=final,
            iterations=it,
            converged=converged,
            stats=mw.stats,
            wall_time=time.perf_counter() - t0,
            per_iteration=per_iter,
        )

    def _global_sync(self, states, aggs, cnts, aux, it,
                     updated_ids, boundary_masks, reads, rowbytes, rec):
        mw = self.mw
        o = mw.options
        # Byte accounting: dense exchange vs lazy upload (Alg. 3).
        mw.stats.dense_bytes += mw.num_shards * mw.n * mw.k * 4
        # The query set is the boundary reads of the blocks that ran.
        queried = list(reads)
        upd_boundary = [
            u[boundary_masks[j][u]].astype(np.int64)
            for j, u in enumerate(updated_ids)
        ]
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
        return [ns.copy() for _ in range(mw.num_shards)], [
            act.copy() for _ in range(mw.num_shards)
        ]


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
    one iteration on the device, and :meth:`_read_extra`, which reads its
    own values from the iteration's fetch.  The base owns the rest: placing
    state, aux and the frontier on the device, the ``init=`` /
    ``frontier=`` overrides, the iteration loop, ONE device→host fetch an
    iteration, the per-iteration records and the single final transfer of
    the state.  The JAX package's between-iteration structure poll
    (elastic migration and graph mutations, ROADMAP Queue A items 9 and
    10) is not ported.
    """

    def __init__(self, mw: Middleware):
        self.mw = mw
        self._use_frontier = (mw.program.frontier_driven
                              and mw.options.frontier_block_skipping)

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

    def run(self, max_iterations: int | None = None, *,
            init=None, frontier=None) -> Result:
        mw = self.mw
        prog = mw.program
        mw.upper.reset()
        max_it = max_iterations or prog.max_iterations
        state0, aux = (init or prog.init)(mw.graph)
        active0 = (np.ones(mw.n, dtype=bool) if frontier is None
                   else np.asarray(frontier, dtype=bool))
        if active0.shape != (mw.n,):
            raise ValueError(f"frontier must have shape ({mw.n},), got "
                             f"{active0.shape}")
        dev = mw.device
        state, aux, active = (torch.as_tensor(a, device=dev)
                              for a in (state0, aux, active0))
        carry = self._init_carry(state, active, active0)
        # captured after _init_carry, which may arm the priority buckets
        stacked = mw.daemon.stacked
        blocks_total = int(sum(bs.num_blocks for bs in mw.blocksets))
        s = mw.num_shards
        per_iter: list[dict] = []
        t0 = time.perf_counter()
        it = 0
        converged = False

        for it in range(1, max_it + 1):
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
            rec.update(extra)
            per_iter.append(rec)
            if done:
                converged = True
                break

        final = carry[0].cpu().numpy()  # the run's one transfer of the state
        return Result(
            state=final,
            iterations=it,
            converged=converged,
            stats=mw.stats,
            wall_time=time.perf_counter() - t0,
            per_iteration=per_iter,
        )


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
        flags = torch.cat([torch.stack([(n_active == 0).long(), n_active]),
                           blocks_run.long()])
        return (new_state, new_active), flags


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
    The JAX package's migration and mutation carries (elasticity and
    dynamic graphs, ROADMAP Queue A items 9 and 10) are not ported.
    """

    def __init__(self, mw: Middleware):
        super().__init__(mw)
        self.m = mw.daemon.m
        self._maskable = (
            isinstance(mw.daemon, MaskCapableDaemon)
            and "run_mask" in inspect.signature(
                mw.upper.merge_partials_async).parameters)
        # the model's constants as float32 values, theta's own type: the
        # products and comparisons round as the JAX package's float32 ones
        self._decay = float(np.float32(mw.model.decay))
        self._floor = float(np.float32(mw.model.floor))
        self._src_masks = None

    def _init_carry(self, state, active, active0):
        mw = self.mw
        model = mw.model
        m, n, dev = self.m, mw.n, mw.device
        masks = None
        if self._maskable:
            mw.daemon.configure_buckets(
                int(getattr(model, "bucket_k", 0) or 0),
                int(getattr(model, "bucket_cap", 32) or 32))
            if self._use_frontier:
                masks = _device_source_masks(mw.partitions, m, n)
                self._src_masks = torch.as_tensor(masks, device=dev)
        # the scheduling state starts all-stale at the identity: the first
        # fresh partials score the highest priority wherever a message is
        held_p = torch.full((m, n, mw.k), mw.program.monoid.identity,
                            dtype=torch.float32, device=dev)
        held_c = torch.zeros((m, n), dtype=torch.int32, device=dev)
        theta0 = np.float32(model.theta0)
        theta = torch.full((), float(theta0), dtype=torch.float32,
                           device=dev)
        # no committed priority yet: float max makes every device run first
        fmax = np.finfo(np.float32).max
        prev_pri = torch.full((m,), float(fmax), dtype=torch.float32,
                              device=dev)
        residual = torch.zeros(n, dtype=torch.float32, device=dev)
        backlog, rows = None, [True] * m
        if self._use_frontier:
            host = np.broadcast_to(active0[None, :], (m, n))
            if masks is not None:
                host = host & masks
            backlog = torch.as_tensor(np.ascontiguousarray(host), device=dev)
            rows = host.any(axis=1).tolist()
        # iteration 1's predict half on the host: prev_pri at float max,
        # the residual zero
        run = [bool((fmax >= theta0) | (theta0 <= np.float32(self._floor)))
               if self._maskable else True] * m
        run_dev = torch.as_tensor(np.array(run), device=dev)
        return (state, backlog, held_p, held_c, theta, prev_pri, residual,
                run_dev, run, rows)

    def _advance(self, carry, aux, it, stacked):
        mw = self.mw
        daemon, upper, prog = mw.daemon, mw.upper, mw.program
        (state, backlog, held_p, held_c, theta, prev_pri, residual, run_dev,
         run, rows) = carry
        act = backlog if self._use_frontier else None
        if self._maskable:
            fresh_p, fresh_c, blocks_run = daemon.run_all_shards(
                state, aux, act, run_mask=run, residual=residual,
                stacked=stacked, live_rows=rows)
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
        done = (n_active == 0) & refreshed.all()
        if self._use_frontier:
            done = done & ~backlog.any()
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
        flags = torch.cat([
            torch.stack([done.long(), n_active]), blocks_run.long(),
            torch.stack([refreshed.sum(), theta.view(torch.int32).long()]),
            run_next.long(), rows_next.long()])
        return (new_state, backlog, held_p, held_c, theta, prev_pri,
                residual, run_dev, run, rows), flags

    def _read_extra(self, carry, extra):
        m = self.m
        n_refreshed, theta_bits = extra[:2]
        run, rows = carry[8], carry[9]
        executed = ([r and a for r, a in zip(run, rows)]
                    if self._use_frontier else run)
        gen_run = sum(executed)
        rec = {"async": True, "refreshed": n_refreshed, "devices": m,
               "theta": np.int32(theta_bits).view(np.float32).item(),
               "gen_run": gen_run, "gen_skipped": m - gen_run,
               "run_mask": run}
        run_next = [bool(x) for x in extra[2:2 + m]]
        rows_next = [bool(x) for x in extra[2 + m:2 + 2 * m]]
        return carry[:8] + (run_next, rows_next), rec
