"""Accelerator backends (the *daemon* role, DESIGN.md §2), as in the JAX
package's ``plug/daemons.py``.

Every daemon implements ``bind(program, n, device=...)`` then
``run_blocks(state, aux, blockset, sel, record) -> (agg, cnt)``:

* ``VectorizedDaemon`` — all selected blocks in one call on the device.
  ``kernel="reference"`` runs the plain block math (gather + Gen +
  segmented Merge + combine); ``kernel="cuda"`` runs the fused CSR-tile
  kernel instead: the blockset is compacted once into dst-grouped tiles
  (graph/compaction.py) and block-granularity frontier selection becomes a
  per-edge mask over the fixed tile layout (``kernels.ops.csr_aggregate``).
* ``BlockedDaemon`` — the paper's Download → Compute → Upload per block;
  ``kernel="cuda"`` runs the edge-block kernel on each block.

The sharded, pipelined and naive daemons come with later slices (ROADMAP
Queue A items 6 and 7); their registry names raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.blocks import BlockSet
from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.plug.protocols import not_ported

KERNELS = ("reference", "cuda")


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


# --------------------------------------------------------------------------
# block programs (shared by the vectorized and blocked daemons)
# --------------------------------------------------------------------------
def block_partials(program: VertexProgram, state, aux, vids, lsrc, ldst, w,
                   emask):
    """Reference block math: per-block Gen + block-local segmented Merge →
    (nb, VB, K) partials (identity at message-free slots), (nb, VB) counts."""
    return kref.edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask,
                                     program=program)


def block_partials_cuda(program: VertexProgram, state, aux, vids, lsrc,
                        ldst, w, emask):
    """The edge-block kernel behind the same contract as
    :func:`block_partials`."""
    return kops.edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask,
                                     program=program)


# One dispatch table for every daemon that runs block programs.
BLOCK_PARTIALS = {
    "reference": block_partials,
    "cuda": block_partials_cuda,
}


def make_block_fn(program: VertexProgram, *, kernel: str = "reference"):
    """Per-block Gen + block-local Merge → (nb, VB, K) partials."""
    _check_kernel(kernel)
    return functools.partial(BLOCK_PARTIALS[kernel], program)


def make_combine_fn(program: VertexProgram, n: int):
    monoid = program.monoid

    def combine(partial, counts, vids):
        k = partial.shape[2]
        flat_ids = vids.reshape(-1)
        agg = monoid.segment_reduce(partial.reshape(-1, k), flat_ids, n)
        cnt = segment_sum(counts.reshape(-1), flat_ids, n)
        # message-free vertices read the monoid identity
        agg = torch.where((cnt > 0)[:, None], agg,
                          torch.full_like(agg, monoid.identity))
        return agg, cnt

    return combine


def gather_blocks(bs: BlockSet, sel: np.ndarray, device):
    """Stacks the selected blocks on ``device``.  Unlike the JAX package,
    ``sel`` is not padded to a power of two: PyTorch runs eagerly, so there
    is no compiled shape to bound."""
    return tuple(torch.from_numpy(a[sel]).to(device)
                 for a in (bs.vids, bs.lsrc, bs.ldst, bs.weights, bs.emask))


def _to_host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


# --------------------------------------------------------------------------
# daemons
# --------------------------------------------------------------------------
class VectorizedDaemon:
    """All active blocks in one call on the device — the optimized path."""

    name = "vectorized"

    def __init__(self, kernel: str = "reference", csr_config=None):
        _check_kernel(kernel)
        self.kernel = kernel
        self.csr_config = csr_config  # None → kops.CSRConfig() defaults
        self.program = None
        self.block_fn = None
        self._combine_fn = None
        self._csr_cache: dict = {}  # id(blockset) -> compacted CSR entry

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        self.program = program
        self.n = num_vertices
        self.device = resolve_device(device)
        self.block_fn = make_block_fn(program, kernel=self.kernel)
        self._combine_fn = make_combine_fn(program, num_vertices)
        self._csr_cache = {}
        return self

    def _csr_entry(self, blockset: BlockSet):
        entry = self._csr_cache.get(id(blockset))
        if entry is not None:
            return entry
        from repro_torch.graph.compaction import tiles_from_blockset

        cfg = self.csr_config or kops.CSRConfig()
        ts = tiles_from_blockset(blockset, self.n, edge_tile=cfg.edge_tile,
                                 hub_threshold=cfg.hub_threshold)
        dev = self.device
        entry = {
            "csr": {k: torch.from_numpy(v).to(dev)
                    for k, v in ts.arrays().items()},
            "eblock": torch.from_numpy(ts.eblock).long().to(dev),
            "num_blocks": blockset.num_blocks,
            "blockset": blockset,  # strong ref: id() keys must not alias
            "config": cfg,
        }
        self._csr_cache[id(blockset)] = entry
        return entry

    def _run_blocks_csr(self, state, aux, blockset, sel):
        entry = self._csr_entry(blockset)
        blk_mask = np.zeros(entry["num_blocks"], bool)
        blk_mask[sel] = True
        blk_mask = torch.from_numpy(blk_mask).to(self.device)
        csr = entry["csr"]
        # block-granularity frontier selection as a per-edge mask: padded
        # slots carry eblock == -1 (wraps to the last block) but their base
        # emask is already False
        em = csr["emask"] & blk_mask[entry["eblock"]]
        agg, cnt = kops.csr_aggregate(
            torch.from_numpy(state).to(self.device),
            torch.from_numpy(aux).to(self.device), dict(csr, emask=em),
            program=self.program, num_vertices=self.n,
            config=entry["config"])
        return _to_host(agg, cnt)

    def run_blocks(self, state, aux, blockset, sel, record):
        if self.kernel == "cuda":
            return self._run_blocks_csr(state, aux, blockset, sel)
        arrs = gather_blocks(blockset, sel, self.device)
        partial, counts = self.block_fn(
            torch.from_numpy(state).to(self.device),
            torch.from_numpy(aux).to(self.device), *arrs)
        return _to_host(*self._combine_fn(partial, counts,
                                          arrs[0].long()))


class BlockedDaemon:
    """The paper's flow collapsed to 3 steps, sequentially per block:
    Download (the block's arrays to the device) → Compute (the block
    program) → Upload (the partial back to the host, merged into the host
    aggregate with the monoid)."""

    name = "blocked"

    def __init__(self, kernel: str = "reference"):
        _check_kernel(kernel)
        self.kernel = kernel
        self.program = None
        self.block_fn = None

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        self.program = program
        self.n = num_vertices
        self.device = resolve_device(device)
        self.block_fn = make_block_fn(program, kernel=self.kernel)
        return self

    def run_blocks(self, state, aux, bs, sel, record):
        monoid = self.program.monoid
        k = self.program.state_width
        dev = self.device
        agg = torch.full((self.n, k), monoid.identity, dtype=torch.float32)
        cnt = np.zeros(self.n, np.int64)
        state_dev = torch.from_numpy(state).to(dev)
        aux_dev = torch.from_numpy(aux).to(dev)

        def download(i: int, slot: dict):
            b = int(sel[i])
            slot["arrs"] = tuple(
                torch.from_numpy(a[b: b + 1]).to(dev)
                for a in (bs.vids, bs.lsrc, bs.ldst, bs.weights, bs.emask))
            slot["vids"] = bs.vids[b]

        def compute(i: int, slot: dict):
            slot["partial"], slot["counts"] = self.block_fn(
                state_dev, aux_dev, *slot["arrs"])

        def upload(i: int, slot: dict):
            partial = slot["partial"][0].cpu()
            counts = slot["counts"][0].cpu().numpy()
            vids = slot["vids"]
            # dispatch through the monoid: an unknown one raises
            monoid.scatter_at(agg, torch.from_numpy(vids), partial)
            np.add.at(cnt, vids, counts)

        res = pl.run_sequential(download, compute, upload, sel.size)
        record.setdefault("sequential", []).append(res)
        return agg.numpy(), cnt.astype(np.int32)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_DAEMONS: dict = {}


def register_daemon(name: str, factory) -> None:
    """Registers a daemon factory; ``factory(**kwargs)`` must return an
    object satisfying the :class:`~repro_torch.plug.protocols.Daemon`
    protocol."""
    _DAEMONS[name] = factory


def get_daemon(name: str, **kwargs):
    """Builds a fresh (unbound) daemon by registry name."""
    try:
        factory = _DAEMONS[name]
    except KeyError:
        raise KeyError(f"unknown daemon {name!r}; registered: "
                       f"{sorted(_DAEMONS)}") from None
    return factory(**kwargs)


def daemon_names() -> tuple:
    return tuple(sorted(_DAEMONS))


register_daemon("vectorized", VectorizedDaemon)
register_daemon("reference", functools.partial(VectorizedDaemon,
                                               kernel="reference"))
# the counterpart of the JAX package's "pallas" daemon
register_daemon("cuda", functools.partial(VectorizedDaemon, kernel="cuda"))
register_daemon("blocked", BlockedDaemon)
register_daemon("sharded", not_ported('daemon="sharded"', 6))
register_daemon("pipelined", not_ported('daemon="pipelined"', 7))
register_daemon("naive", not_ported('daemon="naive"', 7))
