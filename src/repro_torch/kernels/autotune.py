"""Autotuning for the CSR aggregation (the JAX package's
``kernels/autotune.py``).

The CSR daemon program has implementation freedom: the edge-tile size, the
merge (one flat segment reduce by global dst, or per-tile partials merged
by the sorted tile-local segment or by a one-hot product, then the
cross-tile combine), the gather (by index or by a one-hot product) and the
lowering (the hand-written CUDA kernel, or its plain PyTorch twin batched
over tiles).  The best point depends on the device, the graph's shape and
the monoid, so the daemons sweep once per (device, shape, program)
signature and keep the winner in a memo.

Every point computes the same aggregate: min/max/or bit for bit, sum up
to the order of its float32 additions (tests/test_torch_autotune.py holds
every point against the JAX package's counterpart).  Tuning is a choice of
speed only.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.template import VertexProgram
from repro_torch.graph.compaction import build_csr_tiles

LOWERINGS = ("cuda", "torch")
MERGES = ("flat", "sorted", "onehot")
GATHERS = ("take", "onehot")


@dataclasses.dataclass(frozen=True)
class CSRConfig:
    """One point of the CSR aggregation's tuning space.

    A bare ``CSRConfig()`` is the CSR-tile kernel at edge tile 512
    (``lowering="cuda"``, ``merge="sorted"``, ``gather="take"``).  The JAX
    package's bare config is its flat merge (``xla``/``flat``); the port's
    keeps the kernel, which every port caller that writes ``CSRConfig()``
    means.

    Attributes:
      edge_tile: edges per tile (ET); also the degree-bucketing hub
        threshold unless ``hub_threshold`` overrides it.
      lowering: ``"cuda"`` (the CSR-tile kernel, its plain version on CPU
        tensors; the JAX package's ``"pallas"``) or ``"torch"`` (the
        kernel's plain twin batched over tiles, CPU tensors only; the JAX
        package's ``"xla"``).  Ignored when ``merge == "flat"``.
      merge: ``"flat"`` (one segment reduce by global dst straight to
        (N, K): no tile partials, no cross-tile combine; plain PyTorch),
        ``"sorted"`` (per-tile sorted segments) or ``"onehot"`` (a one-hot
        product per tile).  The kernel merges by the sorted segment
        whatever this says, as the CUDA attention kernel tiles by its own
        64 rows whatever ``block_q`` says: the aggregate is the same.
      gather: ``"take"`` (by index) or ``"onehot"`` (a one-hot product);
        ignored by the kernel, which has one gather, and by the flat
        merge.
    """

    edge_tile: int = 512
    lowering: str = "cuda"
    merge: str = "sorted"
    gather: str = "take"
    hub_threshold: int | None = None

    def __post_init__(self):
        for name, value, known in (("lowering", self.lowering, LOWERINGS),
                                   ("merge", self.merge, MERGES),
                                   ("gather", self.gather, GATHERS)):
            if value not in known:
                raise ValueError(f"{name} must be one of {known}, got "
                                 f"{value!r}")

    @property
    def label(self) -> str:
        return f"{self.lowering}/{self.merge}/{self.gather}/et{self.edge_tile}"


#: The counterpart of every point of the JAX package's ``DEFAULT_SPACE``,
#: swept on CPU tensors: the flat merge at three tile sizes, the tiled
#: plain twins, and the kernel (its plain version here) in both gather
#: modes.
CPU_SPACE: tuple[CSRConfig, ...] = (
    CSRConfig(edge_tile=256, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=512, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=1024, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=512, lowering="torch", merge="sorted",
              gather="take"),
    CSRConfig(edge_tile=512, lowering="torch", merge="onehot",
              gather="onehot"),
    CSRConfig(edge_tile=512, lowering="cuda", merge="onehot",
              gather="onehot"),
    CSRConfig(edge_tile=256, lowering="cuda", merge="onehot", gather="take"),
)

#: The space swept on the card: the flat merge at three tile sizes and the
#: kernel at two.  The tiled plain twin never runs on the card, and the
#: kernel has one gather and one merge, so it takes one point per tile
#: size (the one-hot forms are the TPU's matrix-unit devices).
CUDA_SPACE: tuple[CSRConfig, ...] = (
    CSRConfig(edge_tile=256, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=512, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=1024, lowering="torch", merge="flat"),
    CSRConfig(edge_tile=256),
    CSRConfig(edge_tile=512),
)


def default_space(device) -> tuple[CSRConfig, ...]:
    """The space swept on ``device``: :data:`CUDA_SPACE` on the card,
    :data:`CPU_SPACE` on the CPU."""
    return CUDA_SPACE if torch.device(device).type == "cuda" else CPU_SPACE


class AutotuneCache:
    """Process-wide memo of sweep results keyed by problem signature.

    ``sweeps`` counts sweeps stored; ``hits`` counts lookups answered from
    the memo, so a second identically-shaped bind shows as a hit.
    """

    def __init__(self):
        self._entries: dict[tuple, dict] = {}
        self.sweeps = 0
        self.hits = 0

    def clear(self) -> None:
        self._entries.clear()
        self.sweeps = 0
        self.hits = 0

    def lookup(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
        return entry

    def store(self, key, entry) -> None:
        self._entries[key] = entry
        self.sweeps += 1

    def report(self) -> dict:
        """JSON-ready view: every sweep's signature, winner and table
        (seconds per point)."""
        return {
            "sweeps": self.sweeps,
            "hits": self.hits,
            "entries": [
                {
                    "backend": k[0],
                    "num_vertices": k[1],
                    "num_edges": k[2],
                    "state_width": k[3],
                    "aux_width": k[4],
                    "monoid": k[5],
                    "chosen": e["config"].label,
                    "table": e["table"],
                }
                for k, e in sorted(self._entries.items(),
                                   key=lambda kv: repr(kv[0]))
            ],
        }


#: The memo the daemons share.
CACHE = AutotuneCache()


def backend(device) -> str:
    """The device part of a signature: the device type, and on the card
    the card's name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def signature(num_vertices: int, num_edges: int, program: VertexProgram,
              space: tuple[CSRConfig, ...], device="cuda") -> tuple:
    """The memo key.  It carries the program's ``gen_op``: the kernel runs
    only programs that have one, so a winner found for one program cannot
    stand for another of the same shape that the kernel cannot run."""
    return (backend(device), int(num_vertices), int(num_edges),
            program.state_width, program.aux_width, program.monoid.name,
            tuple(c.label for c in space), program.gen_op)


def runnable_space(space: tuple[CSRConfig, ...], program: VertexProgram
                   ) -> tuple[CSRConfig, ...]:
    """The points of ``space`` that can run ``program``: all of them for a
    program with a ``gen_op``, only the points that launch no kernel
    (``lowering="torch"``) for one without, whose ``msg_gen`` the kernel
    cannot compute."""
    if program.gen_op is not None:
        return space
    return tuple(c for c in space if c.lowering == "torch")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_config(tiles, num_vertices, program, config, *, repeats: int,
                 device) -> float:
    """Best of ``repeats`` timed calls of the aggregation at ``config`` over
    ``tiles`` (``CSRTileSet.arrays()``), after one warm-up call (which on
    the card also builds the kernel library at first use)."""
    from repro_torch.kernels import ops

    csr = {k: torch.from_numpy(v).to(device) for k, v in tiles.items()}
    state = torch.ones((num_vertices, program.state_width),
                       dtype=torch.float32, device=device)
    aux = torch.ones((num_vertices, max(program.aux_width, 1)),
                     dtype=torch.float32, device=device)

    def run():
        return ops.csr_aggregate(state, aux, csr, program=program,
                                 num_vertices=num_vertices, config=config)

    run()
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_csr(src: np.ndarray, dst: np.ndarray,
                 weights: np.ndarray | None, num_vertices: int,
                 program: VertexProgram, *,
                 space: tuple[CSRConfig, ...] | None = None,
                 cache: AutotuneCache | None = None,
                 repeats: int = 3, device="cuda") -> CSRConfig:
    """Sweeps the space on this edge list on ``device`` and returns the
    fastest point.  A program without a ``gen_op`` sweeps only the points
    that launch no kernel (:func:`runnable_space`).  Results are memoized
    in ``cache`` (default: :data:`CACHE`) keyed by (device, |V|, |E|, K, A,
    monoid, space, gen_op), so re-binding an identically-shaped problem is
    a lookup.  A point that fails to build or to launch fails the
    sweep."""
    device = torch.device(device)
    space = runnable_space(
        default_space(device) if space is None else tuple(space), program)
    if not space:
        raise ValueError(f"no point of the space can run program "
                         f"{program.name!r} (gen_op=None needs a "
                         "lowering='torch' point)")
    cache = CACHE if cache is None else cache
    key = signature(num_vertices, len(src), program, space, device)
    entry = cache.lookup(key)
    if entry is None:
        tiles: dict = {}  # one compaction per tile cut, shared by points
        table = {}
        for config in space:
            cut = (config.edge_tile, config.hub_threshold)
            if cut not in tiles:
                tiles[cut] = build_csr_tiles(
                    src, dst, weights, num_vertices,
                    edge_tile=config.edge_tile,
                    hub_threshold=config.hub_threshold).arrays()
            table[config.label] = _time_config(
                tiles[cut], num_vertices, program, config, repeats=repeats,
                device=device)
        chosen = min(space, key=lambda c: table[c.label])
        entry = {"config": chosen, "table": table}
        cache.store(key, entry)
    return entry["config"]
