"""Pipeline shuffle (paper Sec. III-A): intra-iteration optimization.

Three layers are reproduced here:

1. **Analytic model** — Eq. (1)/(2) of the paper: lockstep 3-stage pipeline
   (Download / Compute / Upload) over ``s`` equal blocks of size ``b``,
   with per-entity costs ``k1,k2,k3`` and fixed per-block device-call cost
   ``a``; and Lemma 1's closed-form optimal block size ``b_opt``.

2. **Simulators** — ``simulate_lockstep`` (pointer-rotation semantics: all
   three threads advance one block per cycle, cycle cost = max of stage
   costs; this is exactly the regime Eq. (1) models) and
   ``simulate_async`` (unbounded inter-stage queues; a lower bound used to
   quantify what rotation gives up — nothing, when blocks are equal-sized).

3. **Executor** — ``PipelinedExecutor``: the 3-thread implementation with
   rotating buffer *pointers* (no data copies between stages, the paper's
   "shuffle"), synchronized by a per-cycle barrier — the daemon/agent
   Rotate() handshake of Algorithms 1-2; and ``run_sequential``, the
   Download → Compute → Upload baseline the blocked daemon runs.  The
   executor orders the stages' *host* calls; on the card the streaming
   daemons (``plug/daemons.py``) give each stage its own CUDA stream and
   order the device work with events.

4. **Calibration** — ``calibrate`` fits (k1, k2, k3, a) to measured stage
   times by least squares.

A copy of the JAX package's NumPy module; ``optimal_integer_blocks`` is
what ``block_size="auto"`` resolves through.  Unlike the JAX executor,
every barrier wait and thread join here is bounded by ``timeout``, so a
stuck stage fails the run instead of hanging it.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Sequence


# --------------------------------------------------------------------------
# Analytic model (Eq. 1 / Eq. 2)
# --------------------------------------------------------------------------
def stage_times(b: float, k1: float, k2: float, k3: float, a: float):
    return k1 * b, a + k2 * b, k3 * b


def estimate_total_time(
    d: float, b: float, k1: float, k2: float, k3: float, a: float
) -> float:
    """Eq. (2): pipeline makespan for d entities in blocks of size b."""
    b = min(b, d)
    s = max(1, math.ceil(d / b))
    tn, tc, tu = stage_times(b, k1, k2, k3, a)
    if s == 1:
        return tn + tc + tu
    return (
        tn
        + max(tn, tc)
        + (s - 2) * max(tn, tc, tu)
        + max(tc, tu)
        + tu
    )


@dataclasses.dataclass(frozen=True)
class Lemma1Result:
    b_opt: float
    t_min: float
    case: str  # which branch of Lemma 1 fired


def optimal_block_size(d: float, k1: float, k2: float, k3: float, a: float) -> Lemma1Result:
    """Lemma 1: closed-form optimal block size.

    Q = sqrt(a*d / (k1+k3)). Branches:
      * k1 max and a/(k1-k2) < Q  -> b = a/(k1-k2)
      * k3 max and a/(k3-k2) < Q  -> b = a/(k3-k2)
      * otherwise                 -> b = Q
    """
    if min(k1, k2, k3) < 0 or a < 0 or d <= 0:
        raise ValueError("costs must be non-negative, d positive")
    q = math.sqrt(a * d / (k1 + k3)) if (k1 + k3) > 0 else float(d)
    k_max = max(k1, k2, k3)
    if k_max == k1 and k1 > k2 and a / (k1 - k2) < q:
        b = a / (k1 - k2)
        t = k1 * d + (k1 + k3) * a / (k1 - k2)
        case = "k1-bound"
    elif k_max == k3 and k3 > k2 and a / (k3 - k2) < q:
        b = a / (k3 - k2)
        t = k3 * d + (k1 + k3) * a / (k3 - k2)
        case = "k3-bound"
    else:
        b = q
        t = k2 * d + 2.0 * math.sqrt((k1 + k3) * a * d)
        case = "compute-bound(Q)"
    b = max(1.0, min(b, float(d)))
    return Lemma1Result(b_opt=b, t_min=t, case=case)


def optimal_integer_blocks(d: int, k1: float, k2: float, k3: float, a: float):
    """Paper's integrality note: test floor/ceil of s_opt and b_opt via Eq. 2."""
    res = optimal_block_size(d, k1, k2, k3, a)
    cands = set()
    for b in (math.floor(res.b_opt), math.ceil(res.b_opt)):
        if b >= 1:
            cands.add(int(b))
    s_opt = d / res.b_opt
    for s in (math.floor(s_opt), math.ceil(s_opt)):
        if s >= 1:
            cands.add(max(1, math.ceil(d / s)))
    best_b = min(cands, key=lambda b: estimate_total_time(d, b, k1, k2, k3, a))
    return best_b, estimate_total_time(d, best_b, k1, k2, k3, a)


# --------------------------------------------------------------------------
# Simulators
# --------------------------------------------------------------------------
def simulate_lockstep(tn: Sequence[float], tc: Sequence[float], tu: Sequence[float]) -> float:
    """Rotation semantics: one barrier per cycle; cycle cost = max over the
    (up to three) stages active that cycle. Equals Eq. (1) for equal blocks."""
    s = len(tn)
    assert len(tc) == s and len(tu) == s
    total = 0.0
    for cycle in range(s + 2):
        costs = []
        if cycle < s:
            costs.append(tn[cycle])
        if 0 <= cycle - 1 < s:
            costs.append(tc[cycle - 1])
        if 0 <= cycle - 2 < s:
            costs.append(tu[cycle - 2])
        total += max(costs) if costs else 0.0
    return total


def simulate_async(tn: Sequence[float], tc: Sequence[float], tu: Sequence[float]) -> float:
    """Unbounded-queue 3-stage pipeline (no rotation back-pressure)."""
    fn = fc = fu = 0.0
    for i in range(len(tn)):
        fn = fn + tn[i]
        fc = max(fn, fc) + tc[i]
        fu = max(fc, fu) + tu[i]
    return fu


# --------------------------------------------------------------------------
# Executor: 3 threads + rotating buffer pointers + per-cycle barrier
# --------------------------------------------------------------------------
STAGES = ("download", "compute", "upload")


class PipelinedExecutor:
    """Runs download/compute/upload stages over ``num_blocks`` blocks.

    Stage callables receive the block index and a buffer *slot* dict they
    may mutate in place; slots rotate between stages by pointer (list
    permutation), never by copying — the paper's shuffle.  Block ``i``
    lives in slot ``i % 3`` from its download to its upload.

    ``timeout`` (seconds) bounds every barrier wait and every thread join:
    a stage that outlasts it breaks the barrier, and ``run`` raises.
    """

    def __init__(
        self,
        download: Callable[[int, dict], None],
        compute: Callable[[int, dict], None],
        upload: Callable[[int, dict], None],
        *,
        timeout: float = 120.0,
    ):
        self._stages = (download, compute, upload)
        self.timeout = timeout

    def run(self, num_blocks: int) -> dict:
        slots = [dict(), dict(), dict()]  # rotating buffers: n, c, u roles
        n_cycles = num_blocks + 2
        barrier = threading.Barrier(3, timeout=self.timeout)
        stage_busy = [0.0, 0.0, 0.0]
        errors: list[BaseException] = []

        def worker(stage_idx: int):
            fn = self._stages[stage_idx]
            try:
                for cycle in range(n_cycles):
                    block = cycle - stage_idx
                    if 0 <= block < num_blocks:
                        # Buffer for this (stage, cycle): rotation means the
                        # slot a block was downloaded into is the slot it is
                        # computed in next cycle and uploaded from after.
                        slot = slots[block % 3]
                        t0 = time.perf_counter()
                        fn(block, slot)
                        stage_busy[stage_idx] += time.perf_counter() - t0
                    barrier.wait()  # Rotate(): all pointers advance together
            except BaseException as exc:  # surfaced in the caller's thread
                errors.append(exc)
                barrier.abort()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                    name=f"pipeline-{STAGES[i]}")
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive():
                t.join(self.timeout)
                # a broken barrier releases every stage that waits on it; a
                # stage still running one timeout later is stuck in its body
                if t.is_alive() and errors:
                    t.join(self.timeout)
                    if t.is_alive():
                        raise TimeoutError(
                            f"{t.name} still running {self.timeout} s after "
                            "the pipeline broke") from errors[0]
        if errors:
            # the first error is the stage's own; the others are the broken
            # barrier it left behind
            raise errors[0]
        return {
            "wall_time": time.perf_counter() - t0,
            "busy": dict(zip(STAGES, stage_busy)),
        }


def run_sequential(
    download: Callable[[int, dict], None],
    compute: Callable[[int, dict], None],
    upload: Callable[[int, dict], None],
    num_blocks: int,
) -> dict:
    """The "without pipeline" baseline: tightly coupled 3-step execution.
    Returns the executor's record: ``wall_time`` and per-stage ``busy``."""
    slot: dict = {}
    stages = (download, compute, upload)
    busy = [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for i in range(num_blocks):
        for j, fn in enumerate(stages):
            ts = time.perf_counter()
            fn(i, slot)
            busy[j] += time.perf_counter() - ts
    return {"wall_time": time.perf_counter() - t0,
            "busy": dict(zip(STAGES, busy))}


# --------------------------------------------------------------------------
# Calibration: measure k1,k2,k3,a from stage timings (Sec. V, footnote 6)
# --------------------------------------------------------------------------
def calibrate(
    timings: Sequence[tuple[int, float, float, float]],
) -> tuple[float, float, float, float]:
    """Fits (k1,k2,k3,a) from per-block (b, t_n, t_c, t_u) samples.

    t_n ≈ k1*b, t_u ≈ k3*b (through origin); t_c ≈ a + k2*b (affine).
    """
    import numpy as np

    bs = np.array([t[0] for t in timings], dtype=np.float64)
    tns = np.array([t[1] for t in timings], dtype=np.float64)
    tcs = np.array([t[2] for t in timings], dtype=np.float64)
    tus = np.array([t[3] for t in timings], dtype=np.float64)
    k1 = float((bs @ tns) / (bs @ bs))
    k3 = float((bs @ tus) / (bs @ bs))
    A = np.stack([np.ones_like(bs), bs], axis=1)
    coef, *_ = np.linalg.lstsq(A, tcs, rcond=None)
    a, k2 = float(max(coef[0], 0.0)), float(max(coef[1], 0.0))
    return k1, k2, k3, a
