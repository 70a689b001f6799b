"""Out-of-core configuration and the super-shard plan derived from it.

A plain copy of the JAX package's ``oocore/config.py``: dataclasses and
arithmetic, no device.

The planning question is one-dimensional: a shard's work is a sequence
of equally-shaped *columns* (padded blocks for the reference kernel,
padded CSR tiles for the CUDA kernel), each costing a fixed
``col_bytes_dev`` bytes of device memory per logical device of the shard
axis.  Given an HBM
budget the plan splits the column range into

* a **hot prefix** — permanently device-resident cache, sized by
  ``hot_fraction`` of the budget (columns are sorted hottest-first by
  the daemon before planning, so the prefix is the access-frequency hot
  set), and
* **cold super-shards** — equal column groups streamed from host memory.
  Streaming is double-buffered (the next super-shard uploads while the
  current one computes), so the residual budget after the hot set must
  hold *two* super-shard slots.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class OocoreConfig:
    """Knobs for out-of-core execution (``Middleware(oocore=...)``).

    ``hbm_budget`` is in **bytes per logical device** of the shard axis
    and covers the graph's
    column tensors only (vertex state/aux are dense (N, K)/(N, A) arrays
    that remain resident in either mode).  Exactly one of ``hbm_budget``
    or ``num_super_shards`` must be set: the budget derives the split,
    the explicit count forces it (hot set then sized by ``hot_fraction``
    of the *columns* rather than of the budget).
    """

    hbm_budget: int | None = None
    hot_fraction: float = 0.25
    num_super_shards: int | None = None
    prefetch: bool = True

    def __post_init__(self):
        if (self.hbm_budget is None) == (self.num_super_shards is None):
            raise ValueError(
                "OocoreConfig needs exactly one of hbm_budget= (bytes per "
                "device) or num_super_shards= (explicit split)")
        if self.hbm_budget is not None and self.hbm_budget < 0:
            raise ValueError("hbm_budget must be >= 0")
        if self.num_super_shards is not None and self.num_super_shards < 1:
            raise ValueError("num_super_shards must be >= 1")
        if not 0.0 <= self.hot_fraction <= 1.0:
            raise ValueError("hot_fraction must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class OocorePlan:
    """Resolved column layout for one binding of one mesh size."""

    num_cols: int            # stacked columns per shard (nb_max or nt_max)
    col_bytes_dev: int       # device bytes per column per logical device
    hot_cols: int            # resident hottest-first prefix
    num_super_shards: int    # cold groups (0 => everything resident)
    cols_per_super_shard: int
    hbm_budget: int | None
    fits_resident: bool      # whole column range fits the budget

    @property
    def cold_cols(self) -> int:
        return self.num_cols - self.hot_cols

    @property
    def resident_bytes_dev(self) -> int:
        """Steady-state device bytes: hot set + two streaming slots."""
        slots = 2 if self.num_super_shards > 1 else min(self.num_super_shards, 1)
        return (self.hot_cols + slots * self.cols_per_super_shard) * self.col_bytes_dev

    @property
    def super_shard_bytes_dev(self) -> int:
        """Device bytes of one cold super-shard (== one upload)."""
        return self.cols_per_super_shard * self.col_bytes_dev


def plan_super_shards(num_cols: int, col_bytes_dev: int,
                      config: OocoreConfig) -> OocorePlan:
    """Derive the hot/cold column split for one shard-axis length.

    With a byte budget: the hot set takes ``hot_fraction`` of the budget
    (capped at the column count), and the remainder is divided into two
    double-buffer slots whose size bounds the super-shard width.  A
    budget too small even for two single-column slots degrades to
    one-column super-shards — correctness never depends on the budget,
    only the achievable overlap does.
    """
    num_cols = int(num_cols)
    col_bytes_dev = max(int(col_bytes_dev), 1)
    if config.num_super_shards is not None:
        hot = min(num_cols, int(round(config.hot_fraction * num_cols)))
        cold = num_cols - hot
        n_ss = min(config.num_super_shards, cold) if cold else 0
        per = math.ceil(cold / n_ss) if n_ss else 0
        # equal-width groups may cover the cold range in fewer cuts than
        # requested (e.g. 4 columns / 3 groups → width 2 → 2 groups)
        n_ss = math.ceil(cold / per) if per else 0
        return OocorePlan(num_cols=num_cols, col_bytes_dev=col_bytes_dev,
                          hot_cols=hot, num_super_shards=n_ss,
                          cols_per_super_shard=per, hbm_budget=None,
                          fits_resident=(n_ss == 0))

    budget = config.hbm_budget
    fits = num_cols * col_bytes_dev <= budget
    if fits and config.hot_fraction >= 1.0:
        return OocorePlan(num_cols=num_cols, col_bytes_dev=col_bytes_dev,
                          hot_cols=num_cols, num_super_shards=0,
                          cols_per_super_shard=0, hbm_budget=budget,
                          fits_resident=True)
    hot = min(num_cols, int(config.hot_fraction * budget) // col_bytes_dev)
    cold = num_cols - hot
    if cold == 0:
        return OocorePlan(num_cols=num_cols, col_bytes_dev=col_bytes_dev,
                          hot_cols=hot, num_super_shards=0,
                          cols_per_super_shard=0, hbm_budget=budget,
                          fits_resident=fits)
    stream_budget = max(budget - hot * col_bytes_dev, 0)
    slot_cols = max(1, stream_budget // (2 * col_bytes_dev))
    per = min(slot_cols, cold)
    n_ss = math.ceil(cold / per)
    return OocorePlan(num_cols=num_cols, col_bytes_dev=col_bytes_dev,
                      hot_cols=hot, num_super_shards=n_ss,
                      cols_per_super_shard=per, hbm_budget=budget,
                      fits_resident=fits)
