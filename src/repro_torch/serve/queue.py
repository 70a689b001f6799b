"""Admission queue: micro-batching compatible queries (the JAX package's
``serve/queue.py``; no device code).

Requests arrive one at a time; answering each alone would waste the
mesh (one fused step answers B queries for nearly the price of one).
The admission queue groups pending queries by *family* — same kind,
same parameters, hence runnable through the same compiled middleware —
and flushes a family as a batch when it is full or its oldest query has
waited long enough.

Determinism contract: the batching decision
path NEVER reads the wall clock.  All admission/flush decisions are a
pure function of (submission order, the caller-advanced
:class:`VirtualClock`, max_batch, max_wait) — so a latency test replays
identically in CI, and wall time is used only for *measuring* service
time, never for deciding it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable


def _freeze_seeds(seeds) -> tuple:
    """Canonical seed tuple: sorted, deduplicated ints — seed ORDER and
    duplicates never matter to the algorithms (a seed set initializes
    all its members at once), so they must not matter to cache keys
    either."""
    if isinstance(seeds, int) or not isinstance(seeds, Iterable):
        return (int(seeds),)
    frozen = tuple(sorted({int(s) for s in seeds}))
    if not frozen:
        raise ValueError("a query needs at least one seed vertex")
    return frozen


@dataclasses.dataclass(frozen=True)
class Query:
    """One graph question.

    kind: ``"khop"`` | ``"sssp"`` | ``"ppr"`` | ``"lookup"``.
    seeds: this query's seed vertices — an int, or a tuple of ints for
      multi-seed queries (sssp distance-to-set, ppr seed set).
    params: algorithm parameters as a sorted ``(key, value)`` tuple —
      part of the family key, because queries with different parameters
      cannot share a compiled program.
    """

    kind: str
    seeds: tuple
    params: tuple = ()

    @staticmethod
    def make(kind: str, seeds, **params) -> "Query":
        return Query(kind=kind, seeds=_freeze_seeds(seeds),
                     params=tuple(sorted(params.items())))

    @property
    def family_key(self) -> tuple:
        """Queries with equal family keys may ride one batch."""
        return (self.kind, self.params)

    @property
    def cache_key(self) -> tuple:
        """Identity of the ANSWER: kind + seeds + params.  Sound as a
        cache key precisely because the batched programs guarantee
        answers independent of batch composition."""
        return (self.kind, self.seeds, self.params)


class VirtualClock:
    """A caller-advanced clock: the only time source admission reads."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time cannot run backwards (dt={dt})")
        self._t += float(dt)
        return self._t


@dataclasses.dataclass
class _Pending:
    query: Query
    ticket: int
    admitted: float  # virtual time


class AdmissionQueue:
    """Micro-batches compatible queries under a virtual clock.

    A family (same ``Query.family_key``) flushes when it holds
    ``max_batch`` queries, or — at a ``poll()`` — when its oldest
    pending query has waited ≥ ``max_wait`` virtual seconds.  Tickets
    (monotone submission ids) make batch composition reproducible:
    equal submissions + equal clock advances → equal batches, always.
    """

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.005,
                 clock: VirtualClock | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be ≥ 1")
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.clock = clock or VirtualClock()
        self._pending: dict[tuple, list[_Pending]] = {}
        self._ticket = itertools.count()

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def submit(self, query: Query) -> int:
        """Admits one query; returns its ticket.  Never flushes — the
        caller collects full batches via :meth:`poll` so submission
        order alone (not call-site interleaving) decides batching."""
        t = next(self._ticket)
        self._pending.setdefault(query.family_key, []).append(
            _Pending(query, t, self.clock.now()))
        return t

    def poll(self) -> list[list[_Pending]]:
        """Returns the batches due NOW (full families first, then
        families whose oldest query aged past ``max_wait``), removing
        them from the queue.  Deterministic: families are ordered by
        their oldest ticket, and a family larger than ``max_batch``
        flushes in ticket order ``max_batch`` at a time."""
        now = self.clock.now()
        due: list[list[_Pending]] = []
        for key in sorted(self._pending,
                          key=lambda k: self._pending[k][0].ticket):
            fam = self._pending[key]
            while len(fam) >= self.max_batch:
                due.append(fam[:self.max_batch])
                fam = fam[self.max_batch:]
            if fam and now - fam[0].admitted >= self.max_wait:
                due.append(fam)
                fam = []
            self._pending[key] = fam
        self._pending = {k: v for k, v in self._pending.items() if v}
        return due

    def drain(self) -> list[list[_Pending]]:
        """Flushes everything still pending (end of a request window),
        in ticket order, ``max_batch`` at a time."""
        out: list[list[_Pending]] = []
        for key in sorted(self._pending,
                          key=lambda k: self._pending[k][0].ticket):
            fam = self._pending[key]
            for i in range(0, len(fam), self.max_batch):
                out.append(fam[i:i + self.max_batch])
        self._pending = {}
        return out
