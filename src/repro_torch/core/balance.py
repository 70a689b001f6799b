"""Beyond-iteration optimization: workload balancing (paper Sec. III-C).

Cost model per distributed node j:  T_j = c_j * d_j + s * T_call, where
``1/c_j`` is the node's *computation capacity factor* (entities per second)
and ``d_j`` its data load. The balancing objective is
``min max_j c_j * d_j`` (Eq. 5).

Lemma 2 (tune partition sizes {d_j} for fixed capacities {c_j}):
    d_j* = (1/c_j) / sum_i (1/c_i) * D,  giving G* = D / sum_i (1/c_i).

Lemma 3 (tune capacities {1/c_j} for fixed partitions {d_j}, with max
available capacity f):
    1/c_j* = f * d_j / d_max,  giving G* = d_max / f.

These two lemmas also power the *elastic* runtime (dist/fault.py): on node
failure/join we re-run Lemma 2 over the surviving capacities; to decide how
many accelerators a hot shard needs we use Lemma 3.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def makespan(capacities_inv: np.ndarray, loads: np.ndarray) -> float:
    """G = max_j c_j d_j, with capacities given as c_j (seconds/entity)."""
    return float(np.max(np.asarray(capacities_inv) * np.asarray(loads)))


def lemma2_fractions(c: np.ndarray) -> np.ndarray:
    """Optimal load *fractions* d_j/D for per-entity costs c_j (Lemma 2)."""
    c = np.asarray(c, dtype=np.float64)
    if np.any(c <= 0):
        raise ValueError("per-entity costs must be positive")
    inv = 1.0 / c
    return inv / inv.sum()


def lemma2_loads(c: np.ndarray, total: float) -> np.ndarray:
    return lemma2_fractions(c) * total


def lemma2_optimum(c: np.ndarray, total: float) -> float:
    """G* = D / sum(1/c_j)."""
    c = np.asarray(c, dtype=np.float64)
    return float(total / np.sum(1.0 / c))


def lemma3_capacities(d: np.ndarray, f: float) -> np.ndarray:
    """Optimal capacity factors 1/c_j for fixed loads (Lemma 3)."""
    d = np.asarray(d, dtype=np.float64)
    if f <= 0:
        raise ValueError("f must be positive")
    return f * d / d.max()


def lemma3_optimum(d: np.ndarray, f: float) -> float:
    """G* = d_max / f."""
    return float(np.max(np.asarray(d, dtype=np.float64)) / f)


def accelerators_needed(d: np.ndarray, unit_capacity: float, deadline: float) -> np.ndarray:
    """How many unit-capacity accelerators (daemons) each node needs so that
    every node finishes within ``deadline`` — the paper's "dynamically
    allocate idle accelerators to generate more daemons" (Sec. III-C3)."""
    d = np.asarray(d, dtype=np.float64)
    req = d / deadline  # required entities/sec per node
    return np.maximum(1, np.ceil(req / unit_capacity)).astype(np.int64)


@dataclasses.dataclass
class CapacityEstimator:
    """Online estimate of per-entity cost c_j from measured step times.

    The middleware cannot assume spec sheets for heterogeneous accelerators;
    it observes (entities_processed, seconds) per node per iteration and
    keeps an EMA. Stragglers surface as rising c_j and get rebalanced away
    by Lemma 2 (see dist/fault.py).

    ``epoch`` keys the samples to one structure epoch (plug/epoch.py):
    a rebuild changes what an entity costs on a node, so the middleware
    replaces the estimator — never mixes windows — whenever the epoch
    advances.
    """

    num_nodes: int
    ema: float = 0.5
    epoch: int = 0
    _c: np.ndarray | None = None

    def update(self, node: int, entities: float, seconds: float) -> None:
        if self._c is None:
            self._c = np.full(self.num_nodes, np.nan)
        c = seconds / max(entities, 1.0)
        if np.isnan(self._c[node]):
            self._c[node] = c
        else:
            self._c[node] = self.ema * c + (1 - self.ema) * self._c[node]

    @property
    def observed(self) -> bool:
        """True once at least one real measurement arrived — ``costs``
        is the all-ones placeholder until then."""
        return self._c is not None and bool(np.any(~np.isnan(self._c)))

    @property
    def costs(self) -> np.ndarray:
        if self._c is None:
            return np.ones(self.num_nodes)
        out = np.array(self._c)
        fill = np.nanmean(out) if np.any(~np.isnan(out)) else 1.0
        out[np.isnan(out)] = fill
        return out

    def rebalance_fractions(self) -> np.ndarray:
        return lemma2_fractions(self.costs)
