"""Fleet health, straggler rebalancing, elastic re-mesh, as in the JAX
package's ``dist/fault.py`` (beyond-iteration, DESIGN.md §4.3).

The paper's workload balancing (Sec. III-C, Lemmas 2/3 in core/balance.py)
tunes shard sizes to heterogeneous capacities *between* runs; this module
runs the same math continuously against a live fleet:

* ``FleetMonitor`` ingests per-host step times, flags stragglers
  (median-based — robust while fewer than half the fleet lags), converts
  observed costs into Lemma-2 batch fractions, and on host death plans a
  replacement mesh from the survivors;
* ``elastic_plan`` re-meshes N surviving devices: model parallelism is
  load-bearing (a 72B model does not fit one host) so the model axis is
  preserved exactly and the *data* axis shrinks to the largest power of
  two that fits — bounded recompiles, and batch divisibility survives;
* ``reassign_shards`` hands the orphaned data shards of dead hosts to
  survivors in proportion to their Lemma-2 entitlement;
* ``FailureSchedule`` is the deterministic fault-injection seam: "kill
  device d at iteration k" (and optionally "report device d as taking s
  seconds at iteration k"), consumed by ``plug.Middleware`` between
  fused iterations so the whole elastic path is testable on a host mesh.

Everything here is host-side numpy — no device state — so monitors can
run in the launcher process of every host.  On one card the "devices" a
monitor tracks are the logical devices of the shard axis
(``plug.protocols.divisor_mesh``); across ranks they are the world's m,
rank r hosting r·local … (r+1)·local − 1.  Every rank holds the same
schedule, so every rank's monitor records every device's reports and
makes the same plan.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from repro_torch.core import balance

#: single-pod data-axis width of the production mesh (the JAX package's
#: launch/mesh.py);
#: data shards beyond this spill into the "pod" axis.
MAX_DATA_PER_POD = 16


# --------------------------------------------------------------------------
# elastic mesh planning
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A re-mesh target: axis sizes + names, smallest axis last = model."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def devices_used(self) -> int:
        return self.size

    @property
    def model_parallel(self) -> int:
        return self.shape[-1]

    @property
    def data_parallel(self) -> int:
        return self.size // self.shape[-1]


def elastic_plan(num_devices: int, *, model_parallel: int = 16,
                 max_data: int = MAX_DATA_PER_POD) -> MeshPlan:
    """Mesh for ``num_devices`` survivors, preserving the model axis.

    The data-parallel width is the largest power of two ≤
    ``num_devices // model_parallel`` (pow2 keeps microbatch divisibility
    and bounds recompilation to log₂ distinct shapes across a failure
    cascade); widths beyond ``max_data`` spill into a leading "pod" axis,
    matching the production mesh layout.  Raises ``ValueError`` when the
    survivors cannot host even one model replica.
    """
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be ≥ 1, got {model_parallel}")
    if num_devices < model_parallel:
        raise ValueError(
            f"{num_devices} devices cannot host model_parallel="
            f"{model_parallel}; add hosts or shrink the model axis")
    dp = 1 << int(math.floor(math.log2(num_devices // model_parallel)))
    if dp > max_data:
        return MeshPlan((dp // max_data, max_data, model_parallel),
                        ("pod", "data", "model"))
    return MeshPlan((dp, model_parallel), ("data", "model"))


# --------------------------------------------------------------------------
# straggler detection
# --------------------------------------------------------------------------
def detect_stragglers(times, *, factor: float = 1.5) -> np.ndarray:
    """Boolean mask of hosts slower than ``factor`` × the fleet median.

    The median tolerates up to half the fleet lagging; ``factor`` absorbs
    benign jitter (the paper's balancing only pays off when the imbalance
    exceeds the rebalance cost).
    """
    t = np.asarray(times, dtype=np.float64)
    finite = t[np.isfinite(t)]
    if finite.size == 0:
        return np.zeros(t.shape, dtype=bool)
    return t > factor * float(np.median(finite))


def reassign_shards(num_shards: int, fractions, *, cap: int | None = None
                    ) -> np.ndarray:
    """Assigns ``num_shards`` data shards to hosts ∝ ``fractions``.

    Greedy largest-remaining-entitlement: every shard lands on the live
    host (``fractions > 0``) furthest below its Lemma-2 entitlement,
    never exceeding ``cap`` shards per host.  Returns the host index per
    shard; raises ``ValueError`` if no feasible assignment exists (all
    hosts dead, or total capacity < num_shards).
    """
    frac = np.asarray(fractions, dtype=np.float64)
    if frac.ndim != 1 or np.any(frac < 0) or frac.sum() <= 0:
        raise ValueError("fractions must be non-negative with a live host")
    cap_eff = num_shards if cap is None else int(cap)
    entitlement = frac / frac.sum() * num_shards
    load = np.zeros(frac.size)
    out = np.empty(num_shards, dtype=np.int64)
    for s in range(num_shards):
        deficit = entitlement - load
        deficit[frac <= 0] = -np.inf
        deficit[load >= cap_eff] = -np.inf
        h = int(np.argmax(deficit))
        if not np.isfinite(deficit[h]):
            raise ValueError(
                f"cannot place shard {s}: live capacity exhausted "
                f"(cap={cap_eff})")
        out[s] = h
        load[h] += 1
    return out


# --------------------------------------------------------------------------
# deterministic fault injection
# --------------------------------------------------------------------------
class FailureSchedule:
    """Deterministic fault injection: kill device ``d`` at iteration ``k``.

    The middleware polls the schedule between (fused) iterations; a kill
    ``(k, d)`` fires at the first poll whose iteration is ≥ ``k`` — i.e.
    the device dies *before* iteration ``k`` executes, so the state the
    migration carries is exactly the state iteration ``k-1`` produced.
    Every event fires exactly once, no matter how iterations are polled
    (a converged run may never reach ``k``; the event then simply never
    fires — ``exhausted`` reports it).

    Args:
      kills: iterable of ``(iteration, device)`` pairs.
      slow: iterable of ``(iteration, device, seconds)`` — an injected
        per-device step-time report (the straggler seam): at that
        iteration the monitor records ``seconds`` for ``device``, as if
        the device itself had reported it.
      recoveries: iterable of ``(iteration, device)`` pairs — the
        elastic *join* seam: at that iteration the device reports back
        healthy, the monitor un-marks it, and the middleware may grow
        the mesh back (``Middleware.migrate`` plans from the enlarged
        survivor set exactly as it plans shrinks).
    """

    def __init__(self, kills=(), slow=(), recoveries=()):
        self._kills = sorted((int(k), int(d)) for k, d in kills)
        self._slow = sorted((int(k), int(d), float(s)) for k, d, s in slow)
        self._recoveries = sorted((int(k), int(d)) for k, d in recoveries)
        self._next_kill = 0
        self._next_slow = 0
        self._next_recovery = 0

    def kills_at(self, iteration: int) -> list[int]:
        """Devices whose kill events fire at (or before) ``iteration``;
        each event is consumed exactly once."""
        out = []
        while (self._next_kill < len(self._kills)
               and self._kills[self._next_kill][0] <= iteration):
            out.append(self._kills[self._next_kill][1])
            self._next_kill += 1
        return out

    def slow_reports(self, iteration: int) -> list[tuple[int, float]]:
        """``(device, seconds)`` step-time reports due at ``iteration``;
        each is consumed exactly once."""
        out = []
        while (self._next_slow < len(self._slow)
               and self._slow[self._next_slow][0] <= iteration):
            _, d, s = self._slow[self._next_slow]
            out.append((d, s))
            self._next_slow += 1
        return out

    def recoveries_at(self, iteration: int) -> list[int]:
        """Devices whose recovery events fire at (or before)
        ``iteration``; each event is consumed exactly once."""
        out = []
        while (self._next_recovery < len(self._recoveries)
               and self._recoveries[self._next_recovery][0] <= iteration):
            out.append(self._recoveries[self._next_recovery][1])
            self._next_recovery += 1
        return out

    @property
    def exhausted(self) -> bool:
        return (self._next_kill == len(self._kills)
                and self._next_slow == len(self._slow)
                and self._next_recovery == len(self._recoveries))

    def reset(self) -> None:
        """Re-arms every event (a fresh run against the same schedule)."""
        self._next_kill = 0
        self._next_slow = 0
        self._next_recovery = 0


# --------------------------------------------------------------------------
# fleet monitor
# --------------------------------------------------------------------------
class FleetMonitor:
    """Per-host step-time window → stragglers, Lemma-2 fractions, re-mesh.

    One instance lives in the launcher; hosts report wall-clock step times
    via ``record``.  ``batch_fractions`` is safe to apply every step (it
    degrades to uniform with no data); ``remesh`` is the failure path.
    """

    def __init__(self, num_hosts: int, model_parallel: int = 1, *,
                 window: int = 32, straggler_factor: float = 1.5,
                 drift_threshold: float = 0.5):
        if num_hosts < 1:
            raise ValueError("need at least one host")
        self.num_hosts = num_hosts
        self.model_parallel = model_parallel
        self.straggler_factor = straggler_factor
        self.drift_threshold = drift_threshold
        self._times = [collections.deque(maxlen=window)
                       for _ in range(num_hosts)]
        self._failed = np.zeros(num_hosts, dtype=bool)
        self._acked_fractions: np.ndarray | None = None
        self.epoch = 0  # structure epoch the current windows belong to

    # -- ingestion ---------------------------------------------------------
    def record(self, host: int, seconds: float) -> None:
        self._times[host].append(float(seconds))

    def on_epoch(self, version: int) -> None:
        """Keys the step-time windows to a structure epoch.

        A rebuild — ANY rebuild: kill, join, rebalance, oocore re-plan,
        mutation batch — changes what one iteration costs (different
        shards per device, different tile counts, different streamed
        bytes), so samples recorded under the old structure say nothing
        about the new one.  On an epoch change every window is dropped
        structurally, exactly as ``mark_failed`` drops a dead host's
        samples: no later consumer can mix pre-rebuild step times into
        post-rebuild capacity estimates.  Failure flags survive (a dead
        device stays dead across a rebuild it did not cause).

        Each window collapses to ONE synthetic sample — its pre-rebuild
        windowed mean — rather than emptying outright: per-sample
        history under the old structure is stale, but a host's slowness
        *relative to the fleet* is hardware, and forgetting it would
        blind ``stragglers()`` until every host re-reports (a lone
        reporter is its own median).  The *acknowledged baseline* is
        snapshotted from the full old windows first: the placement that
        triggered this epoch was planned against exactly that view, so
        post-rebuild drift is measured as fresh samples vs that
        snapshot — a straggler that keeps the same slowness does not
        re-trigger, one that keeps degrading does.
        """
        version = int(version)
        if version == self.epoch:
            return
        self._acked_fractions = self.batch_fractions()
        for d in self._times:
            if d:
                mean = float(np.mean(d))
                d.clear()
                d.append(mean)
        self.epoch = version

    def mark_failed(self, host: int) -> None:
        """Marks the host dead AND drops its recorded step-time window:
        a dead host's samples must never leak into survivor capacities
        (``batch_fractions``/``mean_times`` already mask dead hosts, but
        clearing the window makes the property structural — no future
        consumer can mix them back in)."""
        self._failed[host] = True
        self._times[host].clear()

    def mark_recovered(self, host: int) -> None:
        """Un-marks a dead host — the elastic *join* path.  The host
        rejoins with an EMPTY step-time window (its pre-failure samples
        were dropped by ``mark_failed`` and say nothing about the
        recovered hardware), so until it reports, capacity views fall
        back to the fleet mean for it — exactly how a never-seen host
        is treated."""
        self._failed[host] = False

    @property
    def failed(self) -> np.ndarray:
        return self._failed.copy()

    @property
    def alive_hosts(self) -> int:
        return int((~self._failed).sum())

    def alive_indices(self) -> np.ndarray:
        """Indices of the surviving hosts, ascending."""
        return np.nonzero(~self._failed)[0]

    @property
    def observed(self) -> bool:
        """True once any live host has a recorded step time."""
        return any(len(d) > 0 for h, d in enumerate(self._times)
                   if not self._failed[h])

    # -- derived views -----------------------------------------------------
    def mean_times(self) -> np.ndarray:
        """Windowed mean step time per host; hosts with no reports (or
        dead) read as NaN."""
        out = np.full(self.num_hosts, np.nan)
        for h, d in enumerate(self._times):
            if d and not self._failed[h]:
                out[h] = float(np.mean(d))
        return out

    def stragglers(self) -> np.ndarray:
        """Median-based straggler mask over live, reporting hosts."""
        return detect_stragglers(self.mean_times(),
                                 factor=self.straggler_factor)

    def batch_fractions(self) -> np.ndarray:
        """Lemma-2 batch fractions: live hosts get load ∝ 1/step-time
        (capacity), dead hosts get exactly 0; sums to 1."""
        t = self.mean_times()
        live = ~self._failed
        costs = np.where(np.isfinite(t), t, np.nanmean(t[live])
                         if np.any(np.isfinite(t[live])) else 1.0)
        frac = np.zeros(self.num_hosts)
        frac[live] = balance.lemma2_fractions(costs[live])
        return frac

    # -- capacity drift ----------------------------------------------------
    def ack_capacity(self) -> np.ndarray:
        """Snapshots the current Lemma-2 fractions as the acknowledged
        baseline the fleet's placement was planned against.

        Call after acting on the monitor's view (a migration, a
        rebalance, or the initial placement).  ``capacity_drift`` then
        measures how far the live view has moved away from this
        baseline — which is what lets a *flagged* straggler that keeps
        degrading trigger further migrations instead of being handled
        exactly once.
        """
        self._acked_fractions = self.batch_fractions()
        return self._acked_fractions

    def capacity_drift(self) -> float:
        """Max relative per-host change of the Lemma-2 fractions vs the
        acknowledged baseline; 0.0 before any ``ack_capacity`` and 0.0
        while no live host has reported under the current epoch (empty
        windows read as uniform — that is absence of evidence, not a
        capacity shift)."""
        if self._acked_fractions is None or not self.observed:
            return 0.0
        cur = self.batch_fractions()
        base = self._acked_fractions
        denom = np.maximum(np.abs(base), 1e-12)
        return float(np.max(np.abs(cur - base) / denom))

    def drifted(self) -> bool:
        """True when capacity has moved past ``drift_threshold`` (0.5 ≈
        some host's entitlement halved or grew by half) since the last
        acknowledged placement."""
        return self.capacity_drift() > self.drift_threshold

    # -- failure path ------------------------------------------------------
    def remesh(self, *, devices_per_host: int) -> MeshPlan:
        """Plan the survivor mesh after the marked failures."""
        return elastic_plan(self.alive_hosts * devices_per_host,
                            model_parallel=self.model_parallel)

    def reassign(self, num_shards: int, *, cap: int | None = None
                 ) -> np.ndarray:
        """Lemma-2 shard → host assignment over the current fleet state."""
        return reassign_shards(num_shards, self.batch_fractions(), cap=cap)


def oocore_replan(num_cols: int, col_bytes_shard: int, num_shards: int,
                  mesh_size: int, config):
    """Re-plans super-shard ownership for a (possibly shorter) shard axis.

    Out-of-core migration is more than moving resident shards: the budget
    is per logical device, and after a kill each survivor holds
    ``num_shards / mesh_size`` shards' columns, so the per-device cost of a
    column grows and the same budget buys fewer resident and streamed
    columns.  This is the one place that conversion happens — the initial
    bind and every remesh call it, so the hot set and the super-shard
    count always reflect the current axis.

    ``config`` is a :class:`~repro_torch.oocore.OocoreConfig`; returns an
    :class:`~repro_torch.oocore.OocorePlan`.
    """
    from repro_torch.oocore.config import plan_super_shards

    if num_shards % mesh_size:
        raise ValueError(f"num_shards={num_shards} not divisible by "
                         f"mesh_size={mesh_size}")
    col_bytes_dev = int(col_bytes_shard) * (num_shards // mesh_size)
    return plan_super_shards(num_cols, col_bytes_dev, config)
