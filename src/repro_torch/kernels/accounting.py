"""The hooks through which the kernel wrappers and the train step report to
the active op counters (``repro_torch.launch.op_analysis.OpCounter``, the
dry run's accounting).  With no counter active each hook does nothing, and
:func:`trips` is ``range``.

A counter registers itself in :func:`counters` while it is open and
offers ``device`` (a device type), ``paused`` (nonzero while it lets an
inner count run), ``weight`` (the factor its events carry),
``note(event)`` and ``planned_launch(name, io_bytes, plain, args,
kwargs)``.  The grids of ranks (``dist/sharding.py``) report each
collective through :func:`collective` and hide their transport's own
dispatch under :func:`paused`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def counters() -> list:
    """The open counters of this thread, the innermost last."""
    if not hasattr(_state, "counters"):
        _state.counters = []
    return _state.counters


def _live() -> list:
    return [c for c in counters() if not c.paused]


def launch(name: str, outputs: tuple, plain, *args, **kwargs) -> None:
    """Reports one launch of kernel ``name`` on ``args`` giving
    ``outputs``: its HBM traffic is its own (every tensor argument read
    once, every output written once), its dot FLOPs are those of its plain
    version ``plain(*args, **kwargs)`` on the same shapes."""
    live = _live()
    if not live:
        return
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outputs)
                 if isinstance(t, torch.Tensor))
    for c in live:
        c.planned_launch(name, nbytes, plain, args, kwargs)


def collective(kind: str, result_bytes: int, group: int, axis: str,
               in_bytes: int) -> None:
    """Reports one collective of ``kind`` (``"all-reduce"``,
    ``"all-gather"``, ``"reduce-scatter"``: what NCCL runs) over a group of
    ``group`` ranks along the grid axis ``axis``, whose result holds
    ``result_bytes`` and whose input ``in_bytes``."""
    for c in _live():
        c.note(["collective", kind, int(result_bytes), int(group),
                int(in_bytes) + int(result_bytes), c.weight, axis])


@contextlib.contextmanager
def paused():
    """The ops inside reach no counter (a collective's transport, which
    reported itself)."""
    live = _live()
    for c in live:
        c.paused += 1
    try:
        yield
    finally:
        for c in live:
            c.paused -= 1


@contextlib.contextmanager
def recompute():
    """Marks the ops inside as a kernel backward's recomputed plain
    forward, counted apart in ``kernel_recompute_dot_flops``."""
    live = _live()
    for c in live:
        c.note(["recompute", 1])
    try:
        yield
    finally:
        for c in live:
            c.note(["recompute", -1])


def trips(n: int):
    """``range(n)`` for a loop whose iterations do the same work.  When
    every live counter traces on the meta device — where nothing is
    computed, so nothing is lost — a loop of three or more runs two
    iterations: 0, and 1 with its events weighed by ``n - 1``.  The second
    stands for the steady state, where the previous iteration's results
    are still alive, so the peak is the full loop's.  A counter on real
    tensors never samples: the loop computes what it computes without
    one."""
    live = _live()
    if n <= 2 or not live or any(c.device != "meta" for c in live):
        yield from range(n)
        return
    for c in live:
        c.note(["loop", n])
    yield 0
    for c in live:
        c.weight *= n - 1
    try:
        yield 1
    finally:
        for c in live:
            c.weight //= n - 1
