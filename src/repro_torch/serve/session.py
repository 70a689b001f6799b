"""The device-facing half of the serving layer (the JAX package's
``serve/session.py``).

A :class:`GraphServeSession` keeps ONE graph resident on the device and
answers query batches against it:

* per query **family** — (kind, params, batch-size bucket) — it builds one
  fused :class:`~repro_torch.plug.middleware.Middleware` whose bound block
  tensors (and, under ``kernel="cuda"``, CSR tiles) are reused across
  every batch of that family: a batch's seeds / restart vectors enter as
  *data* through ``Middleware.run(init=...)``.  Batch sizes are bucketed
  to powers of two (short batches are padded by repeating the tail query —
  duplicate columns are exact under the per-query freeze contract),
  bounding the families at log2(max_batch)+1 per (kind, params).  Under
  ``kernel="cuda"`` the bucket is the CSR-tile kernel's state width K, so
  ``max_batch`` may not exceed the kernel's K ≤ 16.
* **lookup** queries read a host-resident converged analytics state
  (PageRank scores, WCC component ids), computed once per field on the
  same device and then served at memory latency.
* all family middlewares share the session's
  :class:`~repro_torch.dist.fault.FleetMonitor` / failure schedule: a
  device kill observed by one family migrates the others at their own
  next poll (``Middleware._poll_faults`` keys off monitor state, not the
  consumed event), and every migration any run observes is surfaced in
  the batch record so the owner of the result cache can flush the
  affected (non-durable) entries — and ONLY those.

Four keywords place the session: ``device`` (``"cuda"`` by default, a
RankMesh's own device over one; it raises without a GPU unless ``"cpu"``
is asked for), ``mesh`` (the shard
axis' logical devices on the one card, ``None`` = 1, or a
:class:`~repro_torch.dist.sharding.RankMesh`), ``csr_config`` (pins the
CSR aggregation's config; ``None`` autotunes once per family) and
``kernel`` (``"reference"`` block body or the ``"cuda"`` CSR-tile kernel).

Across ``torch.distributed`` ranks (``mesh=RankMesh``) the session's device
is the mesh's, and every family middleware and lookup runs over the mesh:
each rank builds its own shards' tiles and merges through the mesh's
collectives.  Everything that builds or runs a middleware is collective —
every rank calls ``execute_batch``, the lookups and ``apply_mutations``
with the same arguments in the same order, as the serving front end does
on its own: admission reads only the virtual clock, so every rank's
router forms the same batches from the same workload.  Answers are the
replicated state, the same on every rank (an idle rank of a survivor mesh
takes the leader's); ``service_s`` and ``init_s`` are each rank's own.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.pow2 import pow2_bucket
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import RankMesh
from repro_torch.graph import mutation as graph_mutation
from repro_torch.graph.algorithms import (BATCHED_QUERIES, INF, pagerank,
                                          wcc)
from repro_torch.graph.structure import Graph
from repro_torch.kernels.edge_block import _MAX_K
from repro_torch.plug.daemons import ShardedDaemon
from repro_torch.plug.middleware import Middleware
from repro_torch.plug.protocols import PlugOptions
from repro_torch.plug.uppers import MeshUpperSystem

#: kinds answered by a batched multi-source program
BATCH_KINDS = tuple(sorted(BATCHED_QUERIES))
#: analytics fields a lookup query may read
LOOKUP_FIELDS = ("pagerank", "wcc")


def answer_deps(kind: str, seeds, value):
    """Vertex ids a cached answer depends on — the answer's *support*.

    Scoped mutation invalidation is only sound if an entry's dependency set
    covers every vertex whose mutation could change the answer.  For the
    monotone propagate-from-seeds kinds that set is not the seed set but
    the support — the vertices the propagation actually reached (finite
    khop/sssp distance, nonzero ppr mass): an edge mutation can only alter
    the answer if the edge's source already carries distance/mass, i.e.
    sits in the support, and a mutation's dirty region always contains
    both endpoints.  ``lookup`` answers read a converged global analytics
    field (PageRank/WCC fixed points), which any mutation anywhere can
    move — their support is the whole graph, returned as ``None`` (the
    cache's global-deps sentinel).
    """
    seeds = np.asarray([int(s) for s in np.atleast_1d(np.asarray(seeds))],
                       dtype=np.int64)
    if kind == "lookup":
        return None
    value = np.asarray(value)
    if kind in ("khop", "sssp"):
        reached = np.flatnonzero(value < INF)
    else:  # ppr and future mass-propagation kinds
        reached = np.flatnonzero(value != 0)
    return np.union1d(reached.astype(np.int64), seeds)


class GraphServeSession:
    """Executes query batches against one resident graph."""

    def __init__(self, graph: Graph, *, num_shards: int = 8,
                 daemon: str = "sharded", upper: str = "mesh",
                 kernel: str = "reference", max_batch: int = 8,
                 block_size: int | str = "auto",
                 monitor=None, failures=None,
                 analytics_iterations: int = 60,
                 device=None, mesh=None, csr_config=None):
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, got "
                             f"{max_batch}")
        if kernel == "cuda" and max_batch > _MAX_K:
            # the bucket is the CSR-tile kernel's state width K; a wider
            # batch would need the flat merge or a split, and the session
            # does neither behind the caller's back
            raise ValueError(
                f"kernel='cuda' serves batches up to the CSR-tile kernel's "
                f"K <= {_MAX_K} (kernels/csrc/common.cuh kMaxK), got "
                f"max_batch={max_batch}")
        self.device = (mesh.device_for(device) if isinstance(mesh, RankMesh)
                       else resolve_device("cuda" if device is None
                                           else device))
        self.graph = graph
        self.num_shards = num_shards
        self.daemon_name = daemon
        self.upper_name = upper
        self.kernel = kernel
        self.mesh = mesh
        self.csr_config = csr_config
        self.max_batch = int(max_batch)
        self.block_size = block_size
        self.monitor = monitor
        self.failures = failures
        self.analytics_iterations = analytics_iterations
        self.mesh_epoch = 0
        self._families: dict[tuple, dict] = {}
        self._analytics: dict[str, np.ndarray] = {}
        #: seconds each family's and each analytics field's middleware took
        #: to construct (stacking, tile compaction, placement)
        self.init_s: dict = {}

    # -- family executors --------------------------------------------------
    def _program_factory(self, kind: str, params: tuple):
        kw = dict(params)
        factory = BATCHED_QUERIES[kind]
        return lambda seeds: factory(self.graph, seeds, **kw)

    def _donor_daemon(self):
        """Any already-bound family daemon — its device-placed block
        tensors are the adoption donor for the next family (one graph, one
        set of block tensors on the device; see
        ``ShardedDaemon.share_from``)."""
        for fam in self._families.values():
            dm = fam["mw"].daemon
            if getattr(dm, "_stacked", None) is not None:
                return dm
        return None

    def _make_daemon(self):
        if self.daemon_name != "sharded":
            return self.daemon_name
        return ShardedDaemon(kernel=self.kernel, mesh=self.mesh,
                             csr_config=self.csr_config).share_from(
                                 self._donor_daemon())

    def _make_upper(self):
        if self.upper_name == "mesh":
            return MeshUpperSystem(mesh=self.mesh)
        return self.upper_name

    def _middleware(self, graph, program, key) -> Middleware:
        t0 = time.perf_counter()
        mw = Middleware(
            graph, program,
            daemon=self._make_daemon(),
            upper=self._make_upper(), model="bsp",
            num_shards=self.num_shards,
            monitor=self.monitor, failures=self.failures,
            options=PlugOptions(block_size=self.block_size),
            device=self.device)
        self.init_s[key] = time.perf_counter() - t0
        return mw

    def _family(self, kind: str, params: tuple, bucket: int) -> dict:
        key = (kind, params, bucket)
        fam = self._families.get(key)
        if fam is not None:
            return fam
        make = self._program_factory(kind, params)
        program = make([0] * bucket)  # placeholder seeds fix the shapes
        mw = self._middleware(self.graph, program, key)
        fam = {"mw": mw, "make": make, "program": program,
               "durable": program.monoid.idempotent}
        self._families[key] = fam
        return fam

    def execute_batch(self, kind: str, params: tuple, seeds_list,
                      ) -> tuple[list[np.ndarray], dict]:
        """Answers ``len(seeds_list)`` queries of one family in ONE fused
        run.  Returns (answers, record): per query its (N,) state column
        (hop distances / BF distances / PPR scores), and the batch record —
        iterations, wall service time (it ends in the run's one
        vertex-sized fetch, so it holds the device's work), padding,
        whether the answers are durable across migration, and any
        migrations the run observed (the cache-flush signal).
        """
        if kind == "lookup":
            return self._execute_lookup(params, seeds_list)
        if kind not in BATCHED_QUERIES:
            raise ValueError(f"unknown query kind {kind!r}; known: "
                             f"{BATCH_KINDS + ('lookup',)}")
        b = len(seeds_list)
        if b == 0:
            raise ValueError("empty batch")
        if b > self.max_batch:
            raise ValueError(f"batch of {b} exceeds max_batch="
                             f"{self.max_batch}")
        bucket = pow2_bucket(b, self.max_batch)
        fam = self._family(kind, params, bucket)
        padded = list(seeds_list) + [seeds_list[-1]] * (bucket - b)
        init = fam["make"](padded).init
        t0 = time.perf_counter()
        res = fam["mw"].run(init=init)
        service = time.perf_counter() - t0
        migrations = [r["migration"] for r in res.per_iteration
                      if "migration" in r]
        if migrations:
            self.mesh_epoch += len(migrations)
        state = np.asarray(res.state)
        answers = [state[:, q].copy() for q in range(b)]
        record = {
            "kind": kind, "batch": b, "bucket": bucket,
            "iterations": res.iterations, "converged": res.converged,
            "service_s": service, "durable": fam["durable"],
            "migrations": migrations, "mesh_epoch": self.mesh_epoch,
        }
        return answers, record

    # -- lookup ------------------------------------------------------------
    def _analytics_state(self, field: str) -> np.ndarray:
        if field not in LOOKUP_FIELDS:
            raise ValueError(f"unknown lookup field {field!r}; known: "
                             f"{LOOKUP_FIELDS}")
        state = self._analytics.get(field)
        if state is None:
            if field == "pagerank":
                g, prog = self.graph, pagerank(self.graph)
            else:
                g = self.graph.with_reverse_edges()
                prog = wcc(g)
            # the wcc graph carries reverse edges, so its block stacks
            # digest differently and adoption safely contributes nothing
            mw = self._middleware(g, prog, ("lookup", field))
            res = mw.run(max_iterations=self.analytics_iterations)
            if any("migration" in r for r in res.per_iteration):
                self.mesh_epoch += 1
            state = np.asarray(res.state[:, 0])
            self._analytics[field] = state
        return state

    def _execute_lookup(self, params: tuple, seeds_list):
        kw = dict(params)
        field = kw.get("field", "pagerank")
        epoch0 = self.mesh_epoch
        t0 = time.perf_counter()
        state = self._analytics_state(field)
        n = state.shape[0]
        answers = [np.asarray([float(state[s % n]) for s in seeds])
                   for seeds in seeds_list]
        service = time.perf_counter() - t0
        # a first-touch analytics run may itself observe a migration;
        # surface it so the router's cache flush still fires
        migrations = ([{"during": f"analytics:{field}"}]
                      if self.mesh_epoch != epoch0 else [])
        record = {
            "kind": "lookup", "batch": len(seeds_list),
            "bucket": len(seeds_list), "iterations": 0, "converged": True,
            "service_s": service, "durable": True, "migrations": migrations,
            "mesh_epoch": self.mesh_epoch,
        }
        return answers, record

    # -- dynamic graphs ----------------------------------------------------
    def apply_mutations(self, batch) -> np.ndarray:
        """Applies one mutation batch to the served graph and to every
        family middleware; returns the dirty vertex region (touched
        vertices) the owner of the result cache must invalidate.

        The batch lands in the mutation layer's deterministic order, so the
        session graph and each family's independently mutated partitions
        converge to the same structure — families keep their clean shards
        and recut only dirty blocks (each publishes its own ``"mutation"``
        structure epoch).  Converged analytics states are dropped
        wholesale: PageRank/WCC are global fixed points, recomputed on next
        lookup.  Batches that add vertices are only sound for families
        whose program factories derive every shape from ``init(graph)``.
        """
        if isinstance(batch, graph_mutation.MutationLog):
            batch = batch.freeze()
        batch.validate(self.graph.num_vertices)
        if batch.empty:
            return np.empty(0, np.int64)
        self.graph, dirty = graph_mutation.apply_to_graph(self.graph,
                                                          batch)
        for fam in self._families.values():
            fam["mw"].apply_mutations(batch)
        self._analytics.clear()
        return dirty

    # -- introspection -----------------------------------------------------
    @property
    def compiled_families(self) -> list[tuple]:
        """The (kind, params, bucket) executors built so far."""
        return sorted(self._families)
