"""Host-side super-shard layout: reorder, cut, and pad column stacks (the
JAX package's ``oocore/supershard.py``, numpy).

A *column stack* is the daemon's stacked field dict — every array shaped
``(s, cols, ...)`` with shards on axis 0 and blocks/tiles on axis 1.
This module never touches a device: it reorders each shard's columns
hottest-first (per-shard permutation, so each shard keeps its own hot
set), slices off the resident prefix, and cuts the cold remainder into
equal super-shards padded with dead columns.  Dead columns are all-zero
with ``emask`` False, which is exactly the padding convention
``ShardedDaemon.bind_shards`` / ``pad_tileset`` already use: the shard
bodies reduce them to the monoid identity, so padding never changes a
result.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.partition import super_shard_cuts
from repro_torch.oocore.config import OocorePlan


@dataclasses.dataclass
class SuperShardSet:
    """One shard-stack's out-of-core layout, entirely in host memory."""

    plan: OocorePlan
    order: np.ndarray                  # (s, num_cols) per-shard hot-first perm
    hot_host: dict[str, np.ndarray] | None   # (s, hot_cols, ...) or None
    cold_hosts: list[dict[str, np.ndarray]]  # each (s, cols_per_super_shard, ...)
    # per super-shard: unique live source vertices — the prefetch
    # scheduler's index for frontier-aware skipping (a group none of
    # whose sources are active contributes exactly the identity, so it
    # needs neither upload nor compute)
    cold_srcs: list[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def num_super_shards(self) -> int:
        return len(self.cold_hosts)

    def source_index(self) -> tuple[np.ndarray, np.ndarray]:
        """Every cold group's live sources as one flat index: ``(srcs,
        group)`` int64, ``group[i]`` the super-shard that ``srcs[i]``
        belongs to — what a frontier is gathered through to tell, on the
        device, which groups hold an active source."""
        if not self.cold_srcs:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        srcs = np.concatenate(self.cold_srcs).astype(np.int64)
        group = np.repeat(np.arange(len(self.cold_srcs), dtype=np.int64),
                          [a.size for a in self.cold_srcs])
        return srcs, group

    @property
    def super_shard_nbytes(self) -> int:
        """Host bytes of one cold super-shard (== one transfer)."""
        if not self.cold_hosts:
            return 0
        return sum(a.nbytes for a in self.cold_hosts[0].values())


def _take_cols(fields: dict[str, np.ndarray], order: np.ndarray) -> dict:
    """Gather columns of every field by a per-shard permutation/selection."""
    s = order.shape[0]
    rows = np.arange(s)[:, None]
    return {k: np.ascontiguousarray(a[rows, order]) for k, a in fields.items()}


def _pad_cols(fields: dict[str, np.ndarray], width: int) -> dict:
    """Right-pad every field's column axis to ``width`` with dead columns."""
    out = {}
    for k, a in fields.items():
        pad = width - a.shape[1]
        if pad <= 0:
            out[k] = a
            continue
        out[k] = np.concatenate(
            [a, np.zeros((a.shape[0], pad) + a.shape[2:], dtype=a.dtype)],
            axis=1)
    return out


def build_super_shards(fields: dict[str, np.ndarray], scores: np.ndarray,
                       plan: OocorePlan) -> SuperShardSet:
    """Cut a host column stack into hot prefix + equal cold super-shards.

    ``scores`` is ``(s, num_cols)`` — higher means hotter.  Each shard is
    permuted independently (stable sort, so equal-score columns keep
    their block order and the layout is deterministic).
    """
    if not fields:
        raise ValueError("empty field stack")
    s, num_cols = scores.shape
    if num_cols != plan.num_cols:
        raise ValueError(f"plan covers {plan.num_cols} columns, "
                         f"stack has {num_cols}")
    order = np.argsort(-scores, axis=1, kind="stable").astype(np.int64)
    # Only the hot *selection* is frequency-ordered; the cold suffix goes
    # back to natural column order so each super-shard is a contiguous
    # layout range.  Contiguous blocks share sources (tiles of one block
    # trivially; neighbouring blocks on spatially-local graphs), which is
    # what gives the frontier-aware scheduler groups it can actually
    # skip — a frequency-shuffled cold order would smear every vertex's
    # edges across all groups.
    order[:, plan.hot_cols:] = np.sort(order[:, plan.hot_cols:], axis=1)
    hot_slice, cold_slices = super_shard_cuts(
        num_cols, plan.hot_cols, plan.cols_per_super_shard)
    assert len(cold_slices) == plan.num_super_shards
    hot = _take_cols(fields, order[:, hot_slice]) if plan.hot_cols else None
    cold, cold_srcs = [], []
    for sl in cold_slices:
        group = _take_cols(fields, order[:, sl])
        cold.append(_pad_cols(group, plan.cols_per_super_shard))
        cold_srcs.append(np.unique(group["gsrc"][group["emask"]]))
    return SuperShardSet(plan=plan, order=order, hot_host=hot,
                         cold_hosts=cold, cold_srcs=cold_srcs)
