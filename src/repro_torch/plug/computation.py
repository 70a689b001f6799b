"""Computation models as strategy objects (paper Sec. IV-B2), as in the JAX
package's ``plug/computation.py``.

A model decides *when* the daemons run Gen relative to Merge/Apply through
three hooks the drive loop calls: ``prologue(gather)`` before the loop,
``aggregates(gather, pending, record)`` for the aggregates this iteration's
Merge consumes, and ``epilogue(gather, record)`` after Apply.  BSP and GAS
produce identical trajectories on the same template.

:class:`AsyncModel` is PowerGraph-style asynchronous execution with
priority (delta-stepping flavoured) scheduling.  There is no barriered
superstep: every consumer takes the *freshest available* aggregate, and a
producer whose contribution moved less than a decaying priority threshold
``theta`` may stay stale (its last-shipped aggregate keeps being consumed)
until its residual crosses the threshold or the threshold decays under it.
The threshold collapses the moment the frontier drains, so the tail of
every run is barriered (BSP-equivalent) and convergence is exact.
"""
from __future__ import annotations


class BSP:
    """Bulk-synchronous: Gen → Merge → Apply inside one superstep."""

    name = "bsp"
    order = ("gen", "merge", "apply")

    def prologue(self, gather):
        return None

    def aggregates(self, gather, pending, record):
        return gather(record)

    def epilogue(self, gather, record):
        return None


class GAS:
    """Gather-Apply-Scatter ordering: Merge → Apply → Gen; the scatter at
    the end of iteration *t* produces the messages iteration *t+1*
    consumes (PowerGraph's ordering)."""

    name = "gas"
    order = ("merge", "apply", "gen")

    def prologue(self, gather):
        return gather({})

    def aggregates(self, gather, pending, record):
        return pending

    def epilogue(self, gather, record):
        return gather(record)


class AsyncModel:
    """Asynchronous priority execution (PowerGraph-async / delta-stepping).

    Per shard the order is still Gen → Merge → Apply; what changes is the
    superstep boundary: there is none.  Shards consume the freshest
    aggregates available, and a shard whose fresh contribution differs
    from its last-shipped one by less than the priority threshold
    ``theta`` may hold.  ``theta`` starts at ``theta0``, decays by
    ``decay`` every iteration and collapses to 0 when the frontier drains;
    at or below ``floor`` every shard is forced fresh, so the tail of the
    run is BSP-equivalent and the run converges to the barriered models'
    fixed point (exactly, for idempotent monoids).

    Where the staleness lives depends on the drive loop:

    * the **fused device loop** (``daemon="sharded"``, ``upper="mesh"``)
      carries the scheduling state on the device — per-device held
      partials and counts, the frontier backlog gathered while a device
      holds (re-delivered on its next refresh, so no message is lost) and
      ``theta``; see ``plug.middleware.AsyncDriveLoop`` and the upper
      system's ``merge_partials_async``.  A *predict* half decides which
      devices hold before Gen — a held device skips gather + Gen + Merge,
      optionally running only its top-``bucket_k`` residual vertices — and
      the exact *commit* half certifies the refresh on the fresh partials.
    * the **host loop** is itself a global barrier: after its gather every
      aggregate already is the freshest available, so the three hooks
      below are BSP's order.  This is what makes ``model="async"`` safe on
      every composition.
    """

    name = "async"
    # per-shard order; ``barrier`` is what tells this model from BSP
    order = ("gen", "merge", "apply")
    barrier = False

    def __init__(self, theta0: float = 0.1, decay: float = 0.5,
                 floor: float = 1e-12, bucket_k: int = 0,
                 bucket_cap: int = 32):
        if decay <= 0.0 or decay >= 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        if theta0 < 0.0 or floor < 0.0:
            raise ValueError("theta0 and floor must be non-negative")
        if bucket_k < 0 or bucket_cap <= 0:
            raise ValueError("bucket_k must be >= 0 and bucket_cap > 0")
        self.theta0 = float(theta0)
        self.decay = float(decay)
        self.floor = float(floor)
        # vertex-level priority buckets: with bucket_k > 0 a held device
        # still runs the out-edges of its top-bucket_k residual vertices
        # (bucket_cap edges each); idempotent monoids only, since the
        # messages are folded into the held copy by re-combine
        self.bucket_k = int(bucket_k)
        self.bucket_cap = int(bucket_cap)

    def prologue(self, gather):
        return None

    def aggregates(self, gather, pending, record):
        # freshest available: on the barriered host loop, this gather
        return gather(record)

    def epilogue(self, gather, record):
        return None


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_MODELS: dict = {}


def register_model(name: str, factory) -> None:
    _MODELS[name] = factory


def get_model(name: str, **kwargs):
    try:
        factory = _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown computation model {name!r}; registered: "
                       f"{sorted(_MODELS)}") from None
    return factory(**kwargs)


def model_names() -> tuple:
    return tuple(sorted(_MODELS))


register_model("bsp", BSP)
register_model("gas", GAS)
register_model("async", AsyncModel)
