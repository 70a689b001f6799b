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
                   "cuda")`` runs the edge-block CUDA kernel)
``upper=``         ``"host"``
``model=``         ``"bsp"``, ``"gas"``
=================  =====================================================

``device="cuda"`` is the default; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  The fused mesh path, the async model and the
other daemons come with later slices (ROADMAP Queue A).
"""
from repro_torch.plug.computation import (BSP, GAS, get_model, model_names,
                                          register_model)
from repro_torch.plug.daemons import (BlockedDaemon, VectorizedDaemon,
                                      daemon_names, get_daemon,
                                      register_daemon)
from repro_torch.plug.middleware import (HostDriveLoop, Middleware,
                                         make_apply_fn)
from repro_torch.plug.protocols import (ComputationModel, Daemon,
                                        PlugOptions, Result, UpperSystem)
from repro_torch.plug.reference import run_reference
from repro_torch.plug.uppers import (HostUpperSystem, get_upper_system,
                                     register_upper_system,
                                     upper_system_names)

__all__ = [
    "BSP", "GAS", "BlockedDaemon", "ComputationModel", "Daemon",
    "HostDriveLoop", "HostUpperSystem", "Middleware", "PlugOptions",
    "Result", "UpperSystem", "VectorizedDaemon", "daemon_names",
    "get_daemon", "get_model", "get_upper_system", "make_apply_fn",
    "model_names", "register_daemon", "register_model",
    "register_upper_system", "run_reference", "upper_system_names",
]
