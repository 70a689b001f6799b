"""``repro_torch.plug`` — the public middleware API on PyTorch:

    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import pagerank

    g = generate.rmat(10_000, 100_000, seed=0)
    mw = plug.Middleware(g, pagerank(g), daemon="cuda", num_shards=4)
    result = mw.run()

=================  =====================================================
``daemon=``        ``"reference"``/``"vectorized"`` (plain torch blocks),
                   ``"cuda"`` (the CSR-tile CUDA kernel; the JAX
                   package's ``"pallas"``), ``"blocked"``
                   (Download→Compute→Upload; ``BlockedDaemon(kernel=
                   "cuda")`` runs the edge-block CUDA kernel),
                   ``"sharded"`` (all shards stacked on one axis;
                   ``ShardedDaemon(kernel="cuda")`` launches the CSR-tile
                   kernel once an iteration over every shard's tiles),
                   ``"pipelined"`` (the blocked stages overlapped by the
                   pipeline shuffle: a thread and a CUDA stream per
                   stage), ``"naive"`` (a per-edge loop on the host, the
                   Fig. 8 baseline)
``upper=``         ``"host"``, ``"mesh"`` (merges device partials)
``model=``         ``"bsp"``, ``"gas"``, ``"async"`` (``AsyncModel``)
=================  =====================================================

``daemon="sharded"`` with ``upper="mesh"`` runs the device-resident fused
:class:`DriveLoop`:

    mw = plug.Middleware(g, pagerank(g),
                         daemon=plug.get_daemon("sharded", kernel="cuda"),
                         upper="mesh", num_shards=4)

and with ``model=AsyncModel(...)`` the fused :class:`AsyncDriveLoop`, on
m logical devices of the card with ``upper=MeshUpperSystem(mesh=m)``:

    mw = plug.Middleware(g, sssp_bf(g),
                         daemon=plug.get_daemon("sharded", kernel="cuda"),
                         upper=plug.MeshUpperSystem(mesh=4), num_shards=4,
                         model=plug.AsyncModel(theta0=10.0, decay=0.9))

A fused composition survives a change of its shard axis mid-run:
``failures=FailureSchedule(kills=[(k, d)])`` (or a ``FleetMonitor``) kills
logical device d before iteration k, and the run migrates onto the
survivors without a checkpoint; ``recoveries=`` grows the axis back and
``slow=`` step-time reports re-partition a straggler's shards (Lemma 2).
Graphs mutate between runs (``mw.apply_mutations(log)``,
``mw.run_dynamic(log)`` — incremental from the previous fixed point when
the monoid is idempotent and the batch only adds) or mid-run
(``mutations=MutationSchedule(events=[(k, log)])``).  Every rebuild is one
versioned event on ``mw.epochs`` (:class:`StructureEpochBus`).

Out of core, ``oocore=OocoreConfig(hbm_budget=..., hot_fraction=...)``
keeps a hot set of the sharded daemon's columns on the card and streams
the rest from pinned host memory, double-buffered on a copy stream
(:class:`OocoreDriveLoop`); ``mw.oocore_replan(config)`` re-plans it under
a new budget:

    mw = plug.Middleware(g, sssp_bf(g),
                         daemon=plug.get_daemon("sharded", kernel="cuda"),
                         upper="mesh", num_shards=4,
                         oocore=plug.OocoreConfig(hbm_budget=1 << 28))

``device="cuda"`` is the default; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.
"""
from repro_torch.dist.fault import FailureSchedule, FleetMonitor
from repro_torch.graph.mutation import (MutationBatch, MutationLog,
                                        MutationSchedule)
from repro_torch.plug.computation import (BSP, GAS, AsyncModel, get_model,
                                          model_names, register_model)
from repro_torch.plug.daemons import (BlockedDaemon, NaiveDaemon,
                                      PipelinedDaemon, ShardedDaemon,
                                      VectorizedDaemon, daemon_names,
                                      get_daemon, register_daemon)
from repro_torch.plug.epoch import StructureEpoch, StructureEpochBus
from repro_torch.oocore.config import OocoreConfig
from repro_torch.plug.middleware import (AsyncDriveLoop, DriveLoop,
                                         HostDriveLoop, Middleware,
                                         OocoreDriveLoop, make_apply_fn)
from repro_torch.plug.protocols import (BatchQueryCapable, ComputationModel,
                                        Daemon, DevicePartialUpper,
                                        ElasticUpper, MaskCapableDaemon,
                                        OutOfCoreCapable, PlugOptions,
                                        PriorityAsyncModel, Result,
                                        ShardCapableDaemon, UpperSystem)
from repro_torch.plug.reference import run_reference
from repro_torch.plug.uppers import (HostUpperSystem, MeshUpperSystem,
                                     get_upper_system, register_upper_system,
                                     upper_system_names)

__all__ = [
    "AsyncDriveLoop", "AsyncModel", "BSP", "BatchQueryCapable", "GAS",
    "BlockedDaemon", "ComputationModel", "Daemon", "DevicePartialUpper",
    "DriveLoop", "ElasticUpper", "FailureSchedule", "FleetMonitor", "HostDriveLoop",
    "HostUpperSystem", "MaskCapableDaemon", "MeshUpperSystem", "Middleware",
    "MutationBatch", "MutationLog", "MutationSchedule", "NaiveDaemon",
    "OocoreConfig", "OocoreDriveLoop", "OutOfCoreCapable",
    "PipelinedDaemon", "PlugOptions", "PriorityAsyncModel", "Result",
    "ShardCapableDaemon", "ShardedDaemon", "StructureEpoch",
    "StructureEpochBus", "UpperSystem", "VectorizedDaemon",
    "daemon_names", "get_daemon", "get_model", "get_upper_system",
    "make_apply_fn", "model_names", "register_daemon", "register_model",
    "register_upper_system", "run_reference", "upper_system_names",
]
