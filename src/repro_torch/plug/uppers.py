"""Upper systems (the distributed side of the middleware, DESIGN.md §2), as
in the JAX package's ``plug/uppers.py``.

* ``HostUpperSystem`` — the single-host upper system: partitioning, the
  lazy exchange plan, and the cross-shard merge as a fold over the
  per-shard host arrays.  It stays on the host by design: the host drive
  loop's aggregates are host arrays.

The mesh upper system (collective merges across devices) comes with the
device-resident fused loop (ROADMAP Queue A item 6).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.sync import lazy_exchange_plan
from repro_torch.core.template import VertexProgram
from repro_torch.graph.partition import partition_contiguous
from repro_torch.graph.structure import Graph
from repro_torch.plug.protocols import not_ported


class HostUpperSystem:
    """Host-side merge over per-shard arrays."""

    name = "host"

    def partition(self, graph: Graph, num_shards: int, fractions=None):
        """Contiguous edge ranges; ``fractions`` (e.g. from
        ``core.balance.lemma2_fractions``) sizes shards capacity-aware."""
        return partition_contiguous(graph, num_shards, fractions)

    def bind(self, program: VertexProgram, num_shards: int):
        self.program = program
        self.monoid = program.monoid
        self.num_shards = num_shards
        return self

    def reset(self):
        """Called at the start of every ``Middleware.run`` — clears any
        per-run state so repeated runs are reproducible."""

    def exchange(self, updated_boundary, queried):
        return lazy_exchange_plan(updated_boundary, queried)

    def _fold(self, arrays) -> np.ndarray:
        return functools.reduce(
            self.monoid.combine,
            [torch.from_numpy(np.asarray(a)) for a in arrays]).numpy()

    def merge(self, states, aggs, cnts):
        if self.monoid.idempotent:
            # States may have diverged across skipped rounds; the
            # idempotent combine over replicas restores consistency.
            base = self._fold(states)
            agg = self._fold(aggs)
        else:
            base = np.asarray(states[0])
            agg = functools.reduce(np.add, [np.asarray(a) for a in aggs])
        cnt = np.sum(np.stack(cnts), axis=0)
        return base, agg, cnt

    def resolve(self, states):
        if len(states) == 1 or not self.monoid.idempotent:
            return states[0]
        return self._fold(states)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_UPPERS: dict = {}


def register_upper_system(name: str, factory) -> None:
    _UPPERS[name] = factory


def get_upper_system(name: str, **kwargs):
    try:
        factory = _UPPERS[name]
    except KeyError:
        raise KeyError(f"unknown upper system {name!r}; registered: "
                       f"{sorted(_UPPERS)}") from None
    return factory(**kwargs)


def upper_system_names() -> tuple:
    return tuple(sorted(_UPPERS))


register_upper_system("host", HostUpperSystem)
register_upper_system("mesh", not_ported('upper="mesh"', 6))
