"""Deprecated flag-based engine surface — a shim over ``repro_torch.plug``,
as the JAX package's ``core/engine.py`` is over ``repro.plug``.

``GXEngine`` was the original monolith: the daemon backend was a
``use_pallas`` bool, the execution strategy a string switch, and the
upper system a hard-coded host merge.  The middleware lives in
``repro_torch.plug``, composed from three protocols — Daemon / UpperSystem
/ ComputationModel — and this module only maps the legacy flags onto those
components:

====================================  ===================================
legacy ``EngineOptions``              ``repro_torch.plug`` component
====================================  ===================================
``execution="naive"``                 ``daemon="naive"``
``execution="blocked"``               ``daemon="blocked"``
``execution="pipelined"``             ``daemon="pipelined"``
``execution="vectorized"`` (default)  ``daemon="vectorized"``
``use_pallas=True``                   ``kernel="cuda"`` on the daemon
``model="bsp"|"gas"``                 ``model="bsp"|"gas"``
(implicit)                            ``upper="host"``
====================================  ===================================

``kernel="cuda"`` is the port's counterpart of the JAX package's
``"pallas"``: ``vectorized`` then runs the CSR-tile kernel
(``csrc/csr_tile.cu``, pinned at ``CSRConfig()`` so the flag always means
the kernel), ``blocked`` and ``pipelined`` the edge-block kernel
(``csrc/edge_block.cu``); on CPU tensors, their plain versions.
``GXEngine`` takes ``device=`` (default ``"cuda"``) as every entry point
of the port does.

New code should construct ``plug.Middleware`` directly; constructing
``GXEngine`` emits a ``DeprecationWarning`` once per process.
``run_reference`` is re-exported from ``repro_torch.plug.reference``
unchanged.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

from repro_torch.core.template import VertexProgram
from repro_torch.graph.partition import partition_contiguous  # noqa: F401
from repro_torch.graph.structure import EdgePartition, Graph
from repro_torch.kernels.autotune import CSRConfig
from repro_torch.plug import Middleware, PlugOptions, Result, get_daemon
from repro_torch.plug.reference import run_reference  # noqa: F401

# Legacy name for the result dataclass (same object).
EngineResult = Result

# legacy execution flag → plug daemon registry name
_EXECUTION_DAEMONS = {
    "naive": "naive",
    "blocked": "blocked",
    "pipelined": "pipelined",
    "vectorized": "vectorized",
}


@dataclasses.dataclass
class EngineOptions:
    """Legacy flag surface (deprecated — see module docstring)."""

    model: str = "bsp"  # "bsp" | "gas"
    execution: str = "vectorized"  # naive | blocked | pipelined | vectorized
    block_size: int | str = "auto"  # edges per block; "auto" → Lemma 1
    use_pallas: bool = False  # daemon kernel: the CUDA kernels
    sync_caching: bool = True
    sync_skipping: bool = True
    cache_capacity: int = 1 << 14
    frontier_block_skipping: bool = True
    collect_stats: bool = True
    # calibrated Lemma-1 coefficients (entities = edges); refreshed by calibrate()
    k1: float = 2e-8
    k2: float = 6e-8
    k3: float = 2e-8
    a: float = 2e-4

    def to_plug(self) -> PlugOptions:
        return PlugOptions(
            block_size=self.block_size,
            sync_caching=self.sync_caching,
            sync_skipping=self.sync_skipping,
            cache_capacity=self.cache_capacity,
            frontier_block_skipping=self.frontier_block_skipping,
            k1=self.k1, k2=self.k2, k3=self.k3, a=self.a,
        )

    def to_daemon(self):
        """Resolves the (execution, use_pallas) flag pair to a daemon."""
        try:
            name = _EXECUTION_DAEMONS[self.execution]
        except KeyError:
            raise ValueError(
                f"unknown execution mode {self.execution!r}; expected one "
                f"of {tuple(_EXECUTION_DAEMONS)}") from None
        if name == "naive":
            return get_daemon(name)
        if not self.use_pallas:
            return get_daemon(name, kernel="reference")
        if name == "vectorized":
            return get_daemon(name, kernel="cuda", csr_config=CSRConfig())
        return get_daemon(name, kernel="cuda")


class GXEngine:
    """Deprecated: use ``repro_torch.plug.Middleware``.

    Thin delegation shim — translates ``EngineOptions`` flags into plug
    components and forwards everything else.  Attributes the benchmarks
    historically reached into (``blocksets``, ``_block_fn``, ``stats``)
    are preserved as delegating properties.
    """

    _warned = False  # DeprecationWarning emitted once per process

    def __init__(
        self,
        graph: Graph,
        program: VertexProgram,
        partitions: Sequence[EdgePartition] | None = None,
        num_shards: int = 1,
        options: EngineOptions | None = None,
        *,
        device="cuda",
    ):
        if not GXEngine._warned:
            warnings.warn(
                "GXEngine is deprecated; construct "
                "repro_torch.plug.Middleware (daemon=..., upper=..., "
                "model=...) instead",
                DeprecationWarning, stacklevel=2)
            GXEngine._warned = True
        self.options = options or EngineOptions()
        self._mw = Middleware(
            graph, program,
            daemon=self.options.to_daemon(),
            upper="host",
            model=self.options.model,
            partitions=list(partitions) if partitions is not None else None,
            num_shards=num_shards,
            options=self.options.to_plug(),
            device=device,
        )

    def run(self, max_iterations: int | None = None) -> Result:
        return self._mw.run(max_iterations)

    # -- delegation (legacy attribute surface) ------------------------------
    @property
    def graph(self):
        return self._mw.graph

    @property
    def program(self):
        return self._mw.program

    @property
    def partitions(self):
        return self._mw.partitions

    @property
    def num_shards(self):
        return self._mw.num_shards

    @property
    def blocksets(self):
        return self._mw.blocksets

    @property
    def block_size(self):
        return self._mw.block_size

    @property
    def vblock_size(self):
        return self._mw.vblock_size

    @property
    def stats(self):
        return self._mw.stats

    @property
    def device(self):
        return self._mw.device

    @property
    def _block_fn(self):
        return getattr(self._mw.daemon, "block_fn", None)
