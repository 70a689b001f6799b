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

``device="cuda"`` is the default; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  The other options come with later slices
(ROADMAP Queue A).
"""
from repro_torch.plug.computation import (BSP, GAS, AsyncModel, get_model,
                                          model_names, register_model)
from repro_torch.plug.daemons import (BlockedDaemon, NaiveDaemon,
                                      PipelinedDaemon, ShardedDaemon,
                                      VectorizedDaemon, daemon_names,
                                      get_daemon, register_daemon)
from repro_torch.plug.middleware import (AsyncDriveLoop, DriveLoop,
                                         HostDriveLoop, Middleware,
                                         make_apply_fn)
from repro_torch.plug.protocols import (ComputationModel, Daemon,
                                        DevicePartialUpper, MaskCapableDaemon,
                                        PlugOptions, PriorityAsyncModel,
                                        Result, ShardCapableDaemon,
                                        UpperSystem)
from repro_torch.plug.reference import run_reference
from repro_torch.plug.uppers import (HostUpperSystem, MeshUpperSystem,
                                     get_upper_system, register_upper_system,
                                     upper_system_names)

__all__ = [
    "AsyncDriveLoop", "AsyncModel", "BSP", "GAS", "BlockedDaemon",
    "ComputationModel", "Daemon", "DevicePartialUpper", "DriveLoop",
    "HostDriveLoop", "HostUpperSystem", "MaskCapableDaemon",
    "MeshUpperSystem", "Middleware", "NaiveDaemon", "PipelinedDaemon",
    "PlugOptions", "PriorityAsyncModel", "Result",
    "ShardCapableDaemon", "ShardedDaemon", "UpperSystem", "VectorizedDaemon",
    "daemon_names", "get_daemon", "get_model", "get_upper_system",
    "make_apply_fn", "model_names", "register_daemon", "register_model",
    "register_upper_system", "run_reference", "upper_system_names",
]
