"""Power-of-two bucketing/padding — the one shared implementation.

Three layers independently discovered the same trick — pad a varying
size to the next power of two so the number of distinct compiled shapes
stays O(log) instead of O(n):

* the drive loops bucket the active-block count per iteration,
* the sharded daemon pads selected block ids (``pad_pow2``),
* the serving layer buckets batch sizes into query families.

They used to carry three private copies of the arithmetic; this module
is the single source of truth they all import.
"""
from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (``next_pow2(0) == 1``)."""
    if n < 0:
        raise ValueError(f"n must be ≥ 0, got {n}")
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ ``n``, capped at ``cap``.

    ``cap`` itself must be a power of two — a non-pow2 cap would make
    the largest bucket a shape no other size rounds to, defeating the
    point of bucketing.
    """
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"cap must be a power of two ≥ 1, got {cap}")
    return min(next_pow2(n), cap)


def pad_pow2(sel: np.ndarray) -> np.ndarray:
    """Pads a 1-D id array to the next power-of-two length with -1.

    The canonical consumer is block selection: padding entries are
    marked -1 and killed via ``emask`` downstream, so a run sees at most
    ``log2(num_blocks) + 1`` distinct shapes.  ``sel`` is returned
    as-is when already a power of two (no copy).
    """
    n = int(sel.size)
    target = next_pow2(n)
    if target == n:
        return sel
    return np.concatenate(
        [sel, np.full(target - n, -1, dtype=sel.dtype)])
