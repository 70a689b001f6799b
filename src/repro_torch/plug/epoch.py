"""The structure-epoch layer, as in the JAX package's ``plug/epoch.py``:
one event for every "rebuild the step" cause.

The middleware has exactly five reasons to rebuild its fused composition
between iterations — a device kill shrinks the mesh, a recovered device
grows it back, a straggler (or explicit Lemma-2 call) rebalances the
partitions, an out-of-core re-plan recuts super-shards, and a graph
mutation batch rewrites block content.  Before this layer each trigger
hand-called the others' rebuild methods (``upper.remesh`` →
``daemon.remesh`` → reset estimator → drop compiled step), and every new
trigger re-invented the chain.

Now the chain is data: a :class:`StructureEpoch` is a monotonically
versioned description of the structure the run executes against — mesh,
partition map, block/tile layout, out-of-core plan, and the dirty vertex
region of the change — and a :class:`StructureEpochBus` holds the
ordered rebuild hooks (upper collectives, daemon block tensors, capacity
windows, serving caches).  Triggers *publish* a new epoch; subscribers
rebuild in registration order; drive loops notice the version change at
their next between-iteration poll and re-place their carry — they never
call ``remesh``/``replan`` themselves (test-enforced).  On one card the
epoch's ``mesh`` is the int m of logical devices of the shard axis;
across ranks it is the :class:`~repro_torch.dist.sharding.RankMesh` of
the survivor devices, and every rank publishes the same versions.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

#: the causes a structure epoch may carry — the five triggers plus the
#: initial binding.  Anything else is a programming error, caught at
#: publish time so a typo'd cause cannot silently skip cause-sensitive
#: subscribers (the serve cache keys its flush scope off this string).
CAUSES = ("init", "kill", "join", "rebalance", "oocore_replan", "mutation")


@dataclasses.dataclass
class StructureEpoch:
    """One version of the structure a run executes against.

    ``dirty_vertices`` scopes the change: ``None`` means *every* vertex
    may be affected (a re-partition moved arbitrary edges), an array
    means only those vertex ids — the contract mutation batches and
    scoped cache invalidation rely on.  ``meta`` carries free-form
    trigger detail (the migration record, mutation counters, …).
    ``oocore_plan`` is filled in by the daemon hook during publish (the
    plan is an *output* of the rebuild, not an input to it).
    """

    version: int
    cause: str
    mesh: typing.Any
    partitions: tuple
    blocksets: tuple
    oocore_plan: typing.Any = None
    dirty_vertices: np.ndarray | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def global_change(self) -> bool:
        """True when no vertex can be assumed clean under this epoch."""
        return self.dirty_vertices is None


class StructureEpochBus:
    """Versioned publish/subscribe channel for structure changes.

    Hooks are ``fn(new: StructureEpoch, old: StructureEpoch | None)``
    and run in subscription order — the middleware subscribes upper →
    daemon → capacity so the collective mesh exists before block tensors
    are re-placed and capacity windows reset last.  ``rebuilding`` is
    True exactly while hooks run; the enforcement tests use it to prove
    ``remesh``/``replan`` are only ever reached through a publish.
    """

    def __init__(self):
        self._epoch: StructureEpoch | None = None
        self._hooks: list[tuple[str, typing.Callable]] = []
        self._depth = 0

    # -- introspection ----------------------------------------------------
    @property
    def epoch(self) -> StructureEpoch | None:
        return self._epoch

    @property
    def version(self) -> int:
        """The current epoch version; -1 before initialization."""
        return -1 if self._epoch is None else self._epoch.version

    @property
    def rebuilding(self) -> bool:
        """True while a publish is dispatching rebuild hooks."""
        return self._depth > 0

    @property
    def subscribers(self) -> list[str]:
        return [name for name, _ in self._hooks]

    # -- subscription -----------------------------------------------------
    def subscribe(self, name: str, hook) -> None:
        """Registers ``hook`` under ``name`` (replacing any previous hook
        of that name, keeping its position — re-subscription is how a
        component swaps its rebuild logic without reordering)."""
        for i, (n, _) in enumerate(self._hooks):
            if n == name:
                self._hooks[i] = (name, hook)
                return
        self._hooks.append((name, hook))

    def unsubscribe(self, name: str) -> None:
        self._hooks = [(n, h) for n, h in self._hooks if n != name]

    # -- publication ------------------------------------------------------
    def initialize(self, epoch: StructureEpoch) -> StructureEpoch:
        """Installs epoch 0 without dispatching hooks — the initial
        binding already happened imperatively in the constructor; hooks
        describe *changes* from a live structure."""
        if self._epoch is not None:
            raise RuntimeError("bus already initialized")
        if epoch.cause != "init":
            raise ValueError(f"initial epoch must have cause 'init', got "
                             f"{epoch.cause!r}")
        self._epoch = epoch
        return epoch

    def publish(self, cause: str, *, mesh, partitions, blocksets,
                dirty_vertices=None, meta=None) -> StructureEpoch:
        """Builds the next epoch and runs every rebuild hook against it.

        The epoch becomes current only after all hooks ran — a hook that
        raises leaves the bus on the old version, so the failed rebuild
        is visible (version mismatch) rather than half-applied-but-
        acknowledged.
        """
        if cause not in CAUSES or cause == "init":
            raise ValueError(
                f"unknown structure-change cause {cause!r}; "
                f"expected one of {CAUSES[1:]}")
        if self._epoch is None:
            raise RuntimeError("publish before initialize")
        old = self._epoch
        if dirty_vertices is not None:
            dirty_vertices = np.unique(
                np.asarray(dirty_vertices, dtype=np.int64))
        new = StructureEpoch(
            version=old.version + 1, cause=cause, mesh=mesh,
            partitions=tuple(partitions), blocksets=tuple(blocksets),
            dirty_vertices=dirty_vertices, meta=dict(meta or {}))
        self._depth += 1
        try:
            for _, hook in list(self._hooks):
                hook(new, old)
        finally:
            self._depth -= 1
        self._epoch = new
        return new
