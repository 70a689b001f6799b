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
  ``kernel="cuda"`` runs the edge-block kernel on each block.  On the card
  each stage has its own CUDA stream, ordered by events.
* ``PipelinedDaemon`` — the same stages overlapped across blocks by the
  pipeline shuffle (``core.pipeline.PipelinedExecutor``: one thread, and
  on the card one stream, per stage).
* ``NaiveDaemon`` — a per-edge Python loop on the host, the baseline of
  the paper's acceleration ratio (Fig. 8); it computes on the CPU by
  design.
* ``ShardedDaemon`` — every shard's block tensors stacked on a leading
  shard axis and placed on the device once; ``run_all_shards`` does
  gather + Gen + segmented Merge + the per-device combine for all shards in
  one pass and hands (m, N, K) partials, one per logical device of the
  shard axis, to the upper system.  Its extra capability
  (``plug.protocols.ShardCapableDaemon``) is what the middleware detects
  to drive the device-resident fused loop; its masked ``run_all_shards``
  (``plug.protocols.MaskCapableDaemon``) makes the async loop's holds
  free, and its out-of-core binding (``plug.protocols.OutOfCoreCapable``)
  streams super-shards of columns from pinned host memory.

With ``kernel="cuda"`` the CSR aggregation's config is autotuned once per
binding (``kernels.autotune.autotune_csr``) unless ``csr_config`` pins it,
as in the JAX package.
"""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.blocks import BlockSet
from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.edge_block import bucket_partials
from repro_torch.dist.sharding import RankMesh
from repro_torch.plug.protocols import divisor_mesh

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


# a block's arrays in the order the block programs take them
_BLOCK_FIELDS = ("vids", "lsrc", "ldst", "weights", "emask")


def gather_blocks(bs: BlockSet, sel: np.ndarray, device):
    """Stacks the selected blocks on ``device``.  Unlike the JAX package,
    ``sel`` is not padded to a power of two: PyTorch runs eagerly, so there
    is no compiled shape to bound."""
    return tuple(torch.from_numpy(getattr(bs, f)[sel]).to(device)
                 for f in _BLOCK_FIELDS)


def _to_host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


def _live_edges(bs: BlockSet):
    """The real (unpadded) edges of a BlockSet as flat arrays."""
    live = bs.emask.reshape(-1)
    return (bs.gsrc.reshape(-1)[live], bs.gdst.reshape(-1)[live],
            bs.weights.reshape(-1)[live])


# --------------------------------------------------------------------------
# daemons
# --------------------------------------------------------------------------
class VectorizedDaemon:
    """All active blocks in one call on the device — the optimized path."""

    name = "vectorized"

    def __init__(self, kernel: str = "reference", csr_config=None):
        _check_kernel(kernel)
        self.kernel = kernel
        self.csr_config = csr_config  # the caller's pin; None → autotune
        self.program = None
        self.block_fn = None
        self._combine_fn = None
        self._csr_config = None  # resolved per binding
        self._csr_cache: dict = {}  # _edges_key(blockset) -> CSR entry

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        self.program = program
        self.n = num_vertices
        self.device = resolve_device(device)
        self.block_fn = make_block_fn(program, kernel=self.kernel)
        self._combine_fn = make_combine_fn(program, num_vertices)
        # a rebind drops the compacted tiles and the tuned config (the
        # monoid may have changed); an explicit csr_config survives
        self._csr_config = None
        self._csr_cache = {}
        return self

    def _resolve_csr_config(self, src, dst, w):
        """The binding's CSR config: ``csr_config`` if the caller pinned
        one, else the winner of one sweep on these edges
        (``autotune_csr``, memoized per signature).  Resolved at the first
        run, so an unknown monoid raises at run time as on the block path;
        shards run after the first reuse the choice."""
        if self._csr_config is None:
            from repro_torch.kernels import autotune

            self._csr_config = (
                self.csr_config if self.csr_config is not None
                else autotune.autotune_csr(src, dst, w, self.n, self.program,
                                           device=self.device))
        return self._csr_config

    def _csr_entry(self, blockset: BlockSet):
        entry = self._csr_cache.get(_edges_key(blockset))
        if entry is not None and _same_edges(entry["blockset"], blockset):
            return entry
        from repro_torch.graph.compaction import tiles_from_blockset

        cfg = self._resolve_csr_config(*_live_edges(blockset))
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
        self._csr_cache[_edges_key(blockset)] = entry
        return entry

    def prune_block_caches(self, blocksets) -> None:
        """Drops the compacted-tile entries of blocksets that are no longer
        bound — the middleware's structure-epoch daemon hook calls it on
        the host path after a rebuild replaced some (usually not all)
        blocksets.  Surviving blocksets keep their entries: a mutation
        recuts only its dirty shards."""
        live = {_edges_key(bs) for bs in blocksets}
        self._csr_cache = {k: v for k, v in self._csr_cache.items()
                           if k in live}

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


class _StreamingDaemon:
    """Shared Download → Compute → Upload loop of the blocked and pipelined
    daemons, one edge block at a time.

    On the CPU each stage is the JAX package's: download takes the block's
    arrays, compute runs the block program, upload merges the (VB, K)
    partial into the host aggregate with the monoid.  On the card each
    stage has its own CUDA stream (``streams``: copy in, compute, copy
    out) and its own buffers per slot (block ``i`` uses slot ``i % 3``):

    * download writes the block into the slot's pinned host buffers and
      copies them into the slot's device buffers on the copy-in stream
      (``non_blocking``), recording the slot's ``h2d`` event;
    * compute waits for ``h2d`` on the compute stream, runs the block
      program (``kernel="cuda"``: the edge-block kernel) and records
      ``done``;
    * upload waits for ``done`` on the copy-out stream, copies partial and
      counts into the slot's pinned buffers, waits for that copy alone and
      merges on the host.

    Events order the device work; the executor's barrier orders only the
    host's calls, and nothing synchronizes the whole device.  A slot's
    pinned input buffers are rewritten only after its previous ``h2d``
    completed, its device buffers only after its previous ``done``.  The
    first call after ``bind`` runs one block through the three stages in
    the calling thread first, so the kernels' build and first launch
    happen outside the executor's threads.
    """

    pipelined = False

    def __init__(self, kernel: str = "reference"):
        _check_kernel(kernel)
        self.kernel = kernel
        self.program = None
        self.block_fn = None
        self.streams = None

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        self.program = program
        self.n = num_vertices
        self.device = resolve_device(device)
        self.block_fn = make_block_fn(program, kernel=self.kernel)
        self.streams = (tuple(torch.cuda.Stream(self.device)
                              for _ in pl.STAGES)
                        if self.device.type == "cuda" else None)
        self._slot_buffers = {}  # (B, VB, K) -> three slots' buffers
        self._warm = False
        return self

    def run_blocks(self, state, aux, bs, sel, record):
        monoid = self.program.monoid
        agg = torch.full((self.n, self.program.state_width), monoid.identity,
                         dtype=torch.float32)
        cnt = np.zeros(self.n, np.int64)

        def merge(vids, partial, counts):
            # dispatch through the monoid: an unknown one raises
            monoid.scatter_at(agg, torch.from_numpy(vids), partial)
            np.add.at(cnt, vids, counts)

        device_s = None
        if self.streams is None:
            stages = self._host_stages(state, aux, bs, sel, merge)
        else:
            device_s = dict.fromkeys(pl.STAGES, 0.0)
            if not self._warm and sel.size:
                pl.run_sequential(*self._cuda_stages(
                    state, aux, bs, sel[:1], lambda *a: None, dict(device_s)),
                    1)
                self._warm = True
            stages = self._cuda_stages(state, aux, bs, sel, merge, device_s)
        if self.pipelined:
            res = pl.PipelinedExecutor(*stages).run(sel.size)
            record.setdefault("pipeline", []).append(res)
        else:
            res = pl.run_sequential(*stages, sel.size)
            record.setdefault("sequential", []).append(res)
        if device_s is not None:
            res["device"] = device_s  # event-timed span of each stage
        return agg.numpy(), cnt.astype(np.int32)

    def _host_stages(self, state, aux, bs, sel, merge):
        state_t, aux_t = torch.from_numpy(state), torch.from_numpy(aux)

        def download(i: int, slot: dict):
            b = int(sel[i])
            slot["arrs"] = tuple(torch.from_numpy(getattr(bs, f)[b: b + 1])
                                 for f in _BLOCK_FIELDS)
            slot["vids"] = bs.vids[b]

        def compute(i: int, slot: dict):
            slot["partial"], slot["counts"] = self.block_fn(
                state_t, aux_t, *slot["arrs"])

        def upload(i: int, slot: dict):
            merge(slot["vids"], slot["partial"][0],
                  slot["counts"][0].numpy())

        return download, compute, upload

    def _buffers(self, bs):
        """Each slot's pinned host and device buffers for one block shape,
        made once per (B, VB, K)."""
        key = (bs.block_size, bs.vblock_size, self.program.state_width)
        bufs = self._slot_buffers.get(key)
        if bufs is None:
            bufs = []
            like = [torch.from_numpy(getattr(bs, f)[:1])
                    for f in _BLOCK_FIELDS]
            for _ in range(3):
                pin_in = [torch.empty_like(a, pin_memory=True) for a in like]
                bufs.append({
                    "pin_in": pin_in,
                    "dev_in": [torch.empty_like(t, device=self.device)
                               for t in pin_in],
                    "pin_out": (
                        torch.empty((1, key[1], key[2]), dtype=torch.float32,
                                    pin_memory=True),
                        torch.empty((1, key[1]), dtype=torch.int32,
                                    pin_memory=True)),
                })
            self._slot_buffers[key] = bufs
        return bufs

    def _cuda_stages(self, state, aux, bs, sel, merge, device_s):
        copy_in, comp, copy_out = self.streams
        bufs = self._buffers(bs)
        state_dev = torch.from_numpy(state).to(self.device)
        aux_dev = torch.from_numpy(aux).to(self.device)
        # the block programs read the vertex table on the compute stream
        comp.wait_stream(torch.cuda.current_stream(self.device))
        state_dev.record_stream(comp)
        aux_dev.record_stream(comp)

        def event(stream):
            return stream.record_event(torch.cuda.Event(enable_timing=True))

        def download(i: int, slot: dict):
            buf = bufs[i % 3]
            b = int(sel[i])
            with torch.cuda.stream(copy_in):
                if "h2d" in buf:  # the pinned buffers' last copy is done
                    buf["h2d"].synchronize()
                if "done" in buf:  # the last block program read them
                    copy_in.wait_event(buf["done"])
                slot["n0"] = event(copy_in)
                for f, pin, dev in zip(_BLOCK_FIELDS, buf["pin_in"],
                                       buf["dev_in"]):
                    pin.numpy()[0] = getattr(bs, f)[b]
                    dev.copy_(pin, non_blocking=True)
                buf["h2d"] = slot["h2d"] = event(copy_in)
            slot["vids"] = bs.vids[b]

        def compute(i: int, slot: dict):
            buf = bufs[i % 3]
            with torch.cuda.stream(comp):
                comp.wait_event(slot["h2d"])
                slot["c0"] = event(comp)
                partial, counts = self.block_fn(state_dev, aux_dev,
                                                *buf["dev_in"])
                buf["done"] = slot["done"] = event(comp)
            # made on the compute stream, read on the copy-out stream
            partial.record_stream(copy_out)
            counts.record_stream(copy_out)
            slot["partial"], slot["counts"] = partial, counts

        def upload(i: int, slot: dict):
            pin_p, pin_c = bufs[i % 3]["pin_out"]
            with torch.cuda.stream(copy_out):
                copy_out.wait_event(slot["done"])
                u0 = event(copy_out)
                pin_p.copy_(slot["partial"], non_blocking=True)
                pin_c.copy_(slot["counts"], non_blocking=True)
                u1 = event(copy_out)
            u1.synchronize()
            device_s["download"] += slot["n0"].elapsed_time(slot["h2d"]) / 1e3
            device_s["compute"] += slot["c0"].elapsed_time(slot["done"]) / 1e3
            device_s["upload"] += u0.elapsed_time(u1) / 1e3
            merge(slot["vids"], pin_p[0], pin_c[0].numpy())

        return download, compute, upload


class BlockedDaemon(_StreamingDaemon):
    """The paper's flow collapsed to 3 steps, sequentially per block:
    Download (the block's arrays to the device) → Compute (the block
    program) → Upload (the partial back to the host, merged into the host
    aggregate with the monoid)."""

    name = "blocked"


class PipelinedDaemon(_StreamingDaemon):
    """The same three stages overlapped across blocks by the pipeline
    shuffle (paper Sec. III-A): :class:`~repro_torch.core.pipeline.
    PipelinedExecutor` runs each stage in its own thread, and on the card
    on its own CUDA stream."""

    name = "pipelined"
    pipelined = True


class NaiveDaemon:
    """Per-edge Python loop on the host — deliberately slow; exists so the
    acceleration ratio of real daemons is measurable (Fig. 8).  It computes
    on the CPU whatever the device: ``device`` is taken for the protocol
    (and checked), as the middleware's apply runs there."""

    name = "naive"

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        self.program = program
        self.n = num_vertices
        self.device = resolve_device(device)
        return self

    def run_blocks(self, state, aux, bs, sel, record):
        prog = self.program
        monoid = prog.monoid
        agg = torch.full((self.n, prog.state_width), monoid.identity,
                         dtype=torch.float32)
        cnt = np.zeros(self.n, np.int64)
        state_t, aux_t = torch.from_numpy(state), torch.from_numpy(aux)
        weights = torch.from_numpy(bs.weights)
        for b in sel:
            b = int(b)
            for e in range(bs.block_size):
                if not bs.emask[b, e]:
                    continue
                s, d = int(bs.gsrc[b, e]), int(bs.gdst[b, e])
                msg = prog.msg_gen(state_t[s: s + 1], state_t[d: d + 1],
                                   weights[b, e: e + 1].reshape(1, 1),
                                   aux_t[s: s + 1])
                # dispatch through the monoid (an unknown one raises)
                monoid.scatter_at(agg, d, msg)
                cnt[d] += 1
        return agg.numpy(), cnt.astype(np.int32)


class ShardedDaemon(VectorizedDaemon):
    """Every shard's blocks as ONE pass on the device.

    ``bind_shards`` stacks all shards' block tensors on a leading shard
    axis (padded with dead blocks to a common block count) and moves each
    stack to the device once.  ``run_all_shards`` then does gather + Gen +
    segmented Merge *plus the per-device combine* for all shards: the
    shards' partials fold into one (N, K) aggregate per device of the
    shard axis, and the (m, N, K) partials go to the upper system's
    ``merge_partials``.

    The shard axis spans ``m`` logical devices on the one card
    (:func:`~repro_torch.plug.protocols.divisor_mesh`): device g owns the
    contiguous shards g·S/m … (g+1)·S/m − 1, as ``shard_map`` splits the
    JAX package's stacked axis, and its partial folds only those.  Over a
    :class:`~repro_torch.dist.sharding.RankMesh` ``bind_shards`` takes this
    rank's shards only (no rank compacts another's tiles) and stacks them
    for its ``local`` logical devices: ``m`` is then ``local``, and
    ``run_all_shards`` returns (local, N, K) partials, (local, N) counts
    and the rank's own ``blocks_run``.  On a survivor mesh ``local`` may
    differ from rank to rank, and an idle rank binds no shard (``m`` 0,
    nothing stacked).

    ``kernel="cuda"`` runs the CSR aggregation instead of the block
    program: ``bind_shards`` autotunes its config once, on the shard with
    the most live edges (across ranks the world's, swept by its rank and
    broadcast), and pins it on the daemon (unless ``csr_config`` pinned
    it), compacts every shard's blockset into dst-grouped tiles,
    pads the tile sets to a common (nt, RT, ST) envelope and stacks them,
    so an iteration is ONE ``csr_tile`` launch over all S·nt tiles (none
    when the flat merge was chosen).  Frontier skipping becomes a per-edge mask
    (``emask & active[gsrc]``), trajectory-identical to the block path's
    block-granularity skipping for the idempotent monoids that drive
    frontiers, and ``blocks_run`` counts active *tiles*.

    ``run_blocks`` is inherited from :class:`VectorizedDaemon`, so with an
    upper system that cannot merge device partials (``upper="host"``) the
    same instance runs the classic per-shard path.

    Masked execution (:class:`~repro_torch.plug.protocols.MaskCapableDaemon`,
    the async loop's free hold): ``run_all_shards(..., run_mask=)`` takes
    the verdict as host values and runs gather + Gen + Merge only for the
    devices that execute, one pass (one ``csr_tile`` launch) per maximal
    run of consecutive executing devices over a view of their contiguous
    shards.  A held device contributes the identity (or its priority
    bucket's partial, :meth:`configure_buckets`) and runs no tile.
    ``instrument=True`` counts the device bodies run (``gen_invocations``)
    and the bucket runs (``bucket_invocations``) on that path.

    Out of core (:class:`~repro_torch.plug.protocols.OutOfCoreCapable`),
    :meth:`bind_super_shards` keeps a hot set of columns on the device and
    the rest as pinned host super-shards that :meth:`upload_super_shard`
    copies on the current stream; ``run_all_shards(stacked=)`` runs on
    either, one ``csr_tile`` launch each.  Over a RankMesh each rank
    streams its own shards' columns of every super-shard, and every rank
    makes the one-process plan.
    """

    name = "sharded"

    def __init__(self, kernel: str = "reference", mesh=None,
                 axis: str = "shard", csr_config=None):
        super().__init__(kernel, csr_config=csr_config)
        self.mesh = mesh
        self.axis = axis
        self._stacked = None
        self._stacked_digests: dict = {}
        self._donor = None
        self.adopted_fields = 0  # stacked tensors adopted from the donor
        self.num_shards = 0
        self.m = 0
        # per-blockset compacted tiles: a re-bind reuses each BlockSet's
        # tiles instead of compacting it again (the counters show which)
        self._tile_cache: dict = {}
        self.tiles_recut = 0
        self.tilesets_reused = 0
        self._blocksets = None
        # masked execution: priority buckets and the instrumentation that
        # shows a held device never ran its body
        self._bucket_k = 0
        self._bucket_cap = 32
        self.instrument = False
        self.gen_invocations = 0
        self.bucket_invocations = 0
        # out-of-core binding (bind_super_shards)
        self._clear_oocore()

    def share_from(self, donor: "ShardedDaemon | None"):
        """Declares a donor whose stacked device tensors this daemon may
        ADOPT at its next :meth:`bind_shards` instead of placing its own
        copies: one graph, several middlewares, one set of block tensors on
        the device.  Adoption is per field and verified (same device, mesh
        and axis, and a digest of the host-side stack equal to the
        donor's), so a donor bound to another graph or partitioning adds
        nothing.  Returns self."""
        self._donor = donor
        return self

    def bind(self, program: VertexProgram, num_vertices: int, *,
             device="cuda"):
        super().bind(program, num_vertices, device=device)
        # tiles were compacted against the old program and vertex count
        self._stacked = None
        self._tile_cache = {}
        return self

    @property
    def stacked(self):
        """The bound block tensors, stacked on the shard axis and on the
        device (a dict; ``"csr"`` holds the stacked tiles)."""
        return self._stacked

    def bind_shards(self, blocksets, *, mesh=None, axis=None):
        """Stacks every shard's block tensors on a leading axis and places
        them on the device once.  Shards with fewer blocks are padded with
        dead blocks (``emask`` all False: identity partials, zero counts),
        so one rectangular layout serves all shards.  Returns self."""
        self._setup_shard_axis(blocksets, mesh, axis)
        self._clear_oocore()
        if not blocksets:  # an idle rank of a survivor RankMesh
            self._stacked = None
            return self

        # Digest-verified adoption (see share_from).  Digests are recorded
        # whether or not there is a donor, so this daemon can be one.
        donor = self._donor
        donor_ok = (donor is not None and donor is not self
                    and donor._stacked is not None
                    and donor.device == self.device
                    and donor.mesh == self.mesh and donor.axis == self.axis)
        self._stacked_digests = {}
        self.adopted_fields = 0

        def place_or_adopt(name, a):
            d = hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()
            self._stacked_digests[name] = d
            if donor_ok and donor._stacked_digests.get(name) == d:
                adopted = _stacked_field(donor._stacked, name)
                if adopted is not None and tuple(adopted.shape) == a.shape:
                    self.adopted_fields += 1
                    return adopted
            return torch.from_numpy(a).to(self.device)

        self._stacked = {k: place_or_adopt(k, a)
                         for k, a in _host_block_stacks(blocksets).items()}
        if self.kernel == "cuda":
            self._stacked["csr"] = self._stack_csr_tiles(blocksets,
                                                         place_or_adopt)
        return self

    def _setup_shard_axis(self, blocksets, mesh, axis):
        """The shared head of :meth:`bind_shards` and
        :meth:`bind_super_shards`: checks the shard layout and resolves the
        shard axis' length m."""
        if axis is not None:
            self.axis = axis
        if mesh is not None:
            self.mesh = mesh
        s = len(blocksets)
        if isinstance(self.mesh, RankMesh) and self.mesh.idle:
            if s:
                raise ValueError("an idle rank binds no shards")
            self.m = self.num_shards = 0
            self._blocksets = []
            return
        vbs = {bs.vblock_size for bs in blocksets}
        bbs = {bs.block_size for bs in blocksets}
        if len(vbs) != 1 or len(bbs) != 1:
            raise ValueError(
                "bind_shards needs one (block, vblock) shape across shards; "
                f"got B={sorted(bbs)} VB={sorted(vbs)}")
        if isinstance(self.mesh, RankMesh):
            # this rank's shards, split among its own logical devices
            self.m = divisor_mesh(s, self.mesh.local)
        else:
            self.m = divisor_mesh(s, self.mesh)
            self.mesh = self.m
        self.num_shards = s
        self._blocksets = list(blocksets)

    def _stack_csr_tiles(self, blocksets, place, world_envelope=False):
        """Compacts every shard's blockset into CSR tiles (cached per
        BlockSet edge arrays, :func:`_edges_key`: ``tiles_recut`` /
        ``tilesets_reused`` count the split), pads them to a common (nt,
        RT, ST) envelope — with ``world_envelope``, the largest over the
        ranks (:meth:`_world_max`) — and places the stacked fields the
        tile body reads."""
        from repro_torch.graph.compaction import (pad_tileset,
                                                  tiles_from_blockset)

        cfg = self._binding_csr_config(blocksets)
        tiles = []
        for bs in blocksets:
            hit = self._tile_cache.get(_edges_key(bs))
            if hit is not None and _same_edges(hit[0], bs):
                self.tilesets_reused += 1
                tiles.append(hit[1])
                continue
            t = tiles_from_blockset(bs, self.n, edge_tile=cfg.edge_tile,
                                    hub_threshold=cfg.hub_threshold)
            self.tiles_recut += 1
            # the blockset is held strongly so an id() key cannot alias
            self._tile_cache[_edges_key(bs)] = (bs, t)
            tiles.append(t)
        live = {_edges_key(bs) for bs in blocksets}
        self._tile_cache = {k: v for k, v in self._tile_cache.items()
                            if k in live}
        envelope = [max(t.num_tiles for t in tiles),
                    max(t.row_tile for t in tiles),
                    max(t.src_tile for t in tiles)]
        nt, rt, st = (self._world_max(envelope) if world_envelope
                      else envelope)
        arrays = [pad_tileset(t, num_tiles=nt, row_tile=rt,
                              src_tile=st).arrays() for t in tiles]
        fields = _CSR_FIELDS + (("gdst",) if cfg.merge == "flat" else ())
        return {k: place("csr/" + k, np.stack([a[k] for a in arrays]))
                for k in fields}

    def _binding_csr_config(self, blocksets):
        """The CSR config this binding compacts with: the pinned one, the
        one resolved already, or the winner of one sweep on the shard with
        the most live edges (the first such shard).  Across ranks that is
        the world's largest shard: the rank holding it sweeps and
        broadcasts the winner, so the world sweeps once and every rank
        binds one config, as the JAX package's one sweep does.  A rank
        back from idle takes the config its group holds."""
        live = [int(bs.emask.sum()) for bs in blocksets]
        big = blocksets[int(np.argmax(live))]
        rm = self.mesh
        if not isinstance(rm, RankMesh) or self.csr_config is not None:
            return self._resolve_csr_config(*_live_edges(big))
        views = rm.all_gather_host((self._csr_config, max(live)))
        held = [c for c, _ in views if c is not None]
        if held:
            self._csr_config = held[0]
            return self._csr_config
        src = rm.members[int(np.argmax([e for _, e in views]))]
        if rm.rank == src:
            self._resolve_csr_config(*_live_edges(big))
        self._csr_config = rm.broadcast_host(self._csr_config, src)
        return self._csr_config

    def _world_max(self, sizes) -> list:
        """``sizes`` (ints), over a RankMesh their largest over the ranks:
        an out-of-core binding pads every rank's columns to the
        one-process stack's shape, so its plan and column bytes are the
        same on every rank."""
        if isinstance(self.mesh, RankMesh):
            sizes = self.mesh.all_reduce_host(np.array(sizes, np.int64),
                                              "max")
        return [int(x) for x in sizes]

    # -- out-of-core (OutOfCoreCapable) ----------------------------------
    def _clear_oocore(self):
        self._oocore_config = None
        self._cold = []
        self._cold_srcs = []
        self._cold_index = None
        self.oocore_plan = None
        self.num_super_shards = 0
        self.hot_stacked = None

    def bind_super_shards(self, blocksets, *, mesh=None, axis=None,
                          config=None):
        """The out-of-core binding: host column stacks and a device hot set.

        Instead of placing the full stacked tensors on the device
        (:meth:`bind_shards`), the columns — padded blocks, or CSR tiles
        under ``kernel="cuda"`` — stay in host memory, reordered hottest
        first by an access-frequency score (summed live out-degree,
        :func:`~repro_torch.graph.compaction.tile_access_scores`), and are
        split per ``config`` (an :class:`~repro_torch.oocore.OocoreConfig`):
        the hot prefix is placed once and stays on the device; the cold
        remainder is cut into equal super-shards, each pinned once (on the
        card) and served by :meth:`upload_super_shard`.  The plan is made
        for the current shard-axis length
        (:func:`~repro_torch.dist.fault.oocore_replan`), so a post-kill
        :meth:`remesh` re-plans for the survivors' larger per-device column
        cost.  The CSR stack holds the fields the shard body reads (``gdst``
        only for the flat merge), so a column weighs less than the JAX
        package's, which streams every tile field.

        Over a :class:`~repro_torch.dist.sharding.RankMesh` a rank stacks
        only its own shards, and the plan's inputs are the world's, so
        every rank makes the plan one process makes for the whole axis:
        the columns are padded to the ranks' largest (nt, RT, ST) envelope
        (block count for the block body), the access scores read the sum
        of every rank's out-degree counts, and the CSR config is the one
        of :meth:`_binding_csr_config`.  The budget stays per logical
        device.  An idle rank binds nothing and frees what it held; it
        keeps ``config`` for a join.  Returns self."""
        from repro_torch.dist import fault as dist_fault
        from repro_torch.graph.compaction import tile_access_scores
        from repro_torch.oocore.supershard import build_super_shards

        if config is None:
            config = self._oocore_config
        if config is None:
            raise ValueError("bind_super_shards needs an OocoreConfig")
        self._setup_shard_axis(blocksets, mesh, axis)
        self._stacked = None
        if not blocksets:  # an idle rank of a survivor RankMesh
            self._clear_oocore()
            self._oocore_config = config  # a join re-binds under it
            return self
        if self.kernel == "cuda":
            fields = self._stack_csr_tiles(blocksets, lambda name, a: a,
                                           world_envelope=True)
        else:
            (nb,) = self._world_max([max(bs.num_blocks
                                         for bs in blocksets)])
            fields = _host_block_stacks(blocksets, nb)
        gsrc, emask = fields["gsrc"], fields["emask"]
        # the access scores read every shard's live out-degree: across
        # ranks the sum of each rank's counts
        deg = np.bincount(gsrc[emask].ravel(), minlength=self.n)
        if isinstance(self.mesh, RankMesh):
            deg = self.mesh.all_reduce_host(deg, "sum")
        scores = tile_access_scores(gsrc, emask, deg)
        col_bytes_shard = sum(
            int(a.itemsize) * int(np.prod(a.shape[2:], dtype=np.int64))
            for a in fields.values())
        plan = dist_fault.oocore_replan(scores.shape[1], col_bytes_shard,
                                        self.num_shards, self.m, config)
        sss = build_super_shards(fields, scores, plan)
        del fields
        dev = self.device
        pin = dev.type == "cuda"
        self._stacked_digests = {}
        self.adopted_fields = 0
        self._oocore_config = config
        self.oocore_plan = plan
        self.num_super_shards = plan.num_super_shards
        self.hot_stacked = (self._wrap_oocore(
            {k: torch.from_numpy(a).to(dev) for k, a in sss.hot_host.items()})
            if sss.hot_host is not None else None)
        # each cold group's numpy copy goes once it is pinned, so the cold
        # columns sit in host memory once
        self._cold = []
        while sss.cold_hosts:
            group = sss.cold_hosts.pop(0)
            self._cold.append({k: (torch.from_numpy(a).pin_memory() if pin
                                   else torch.from_numpy(a))
                               for k, a in group.items()})
        self._cold_srcs = sss.cold_srcs
        srcs, group = sss.source_index()
        self._cold_index = (torch.from_numpy(srcs).to(dev),
                            torch.from_numpy(group).to(dev))
        return self

    def upload_super_shard(self, index: int, out=None, copy: bool = True):
        """Copies cold super-shard ``index`` to the device on the current
        stream (``non_blocking`` from pinned memory on the card; the host
        arrays themselves on the CPU) → a dict ``run_all_shards(stacked=)``
        takes.  ``out``, a dict this returned before, is overwritten and
        returned instead of allocating (the groups share one shape).
        ``copy=False`` returns fresh device tensors of the group's shapes,
        uninitialized: a slot to upload into."""
        if self.oocore_plan is None:
            raise RuntimeError(
                "upload_super_shard before bind_super_shards")
        host = self._cold[index]
        if not copy:
            return self._wrap_oocore(
                {k: torch.empty_like(t, device=self.device)
                 for k, t in host.items()})
        if out is None:
            return self._wrap_oocore(
                {k: t.to(self.device, non_blocking=True)
                 for k, t in host.items()})
        dst = out["csr"] if self.kernel == "cuda" else out
        for k, t in host.items():
            dst[k].copy_(t, non_blocking=True)
        return out

    @property
    def super_shard_nbytes(self) -> int:
        """Host bytes of one cold super-shard (== one upload)."""
        return (sum(t.numel() * t.element_size()
                    for t in self._cold[0].values()) if self._cold else 0)

    def super_shard_active(self, index: int, active) -> bool:
        """Does cold super-shard ``index`` touch any active source?  The
        host twin of the shard body's per-edge ``emask & active[gsrc]``:
        when no live source of the group is active its partial is exactly
        the monoid identity, so it needs neither upload nor compute.
        ``active`` is a host (N,) bool."""
        srcs = self._cold_srcs[index]
        return bool(np.any(active[srcs])) if srcs.size else False

    def super_shard_activity(self, active):
        """:meth:`super_shard_active` of every cold group at once, on the
        device: ``active`` (N,) bool → (num_super_shards,) bool, with no
        host round trip."""
        srcs, group = self._cold_index
        hits = torch.zeros(self.num_super_shards, dtype=torch.int32,
                           device=active.device)
        hits.index_add_(0, group, active[srcs].to(torch.int32))
        return hits > 0

    def _wrap_oocore(self, placed):
        # the CSR body reads the tiles under a "csr" key; the block body
        # reads the block fields at the top level
        return {"csr": placed} if self.kernel == "cuda" else placed

    def remesh(self, mesh, *, blocksets=None, config=None):
        """Re-stacks the bound block tensors over a survivor shard axis of
        ``mesh`` logical devices — the daemon half of checkpoint-free
        migration.  Each logical device's slice of the stacked axis grows
        from S/m to S/m′ shards.  ``blocksets`` replaces the bound layout
        when the migration also re-partitioned or re-ordered the shards;
        omitted, the layout of the last ``bind_shards`` is re-placed.  A
        re-ordered BlockSet keeps its identity, so its compacted tiles are
        reused (``tilesets_reused``), and the binding's CSR config stays:
        a migration never sweeps again.  The priority buckets are not
        re-stacked: the async loop re-arms them.  An out-of-core binding is
        re-planned for the new axis (:meth:`bind_super_shards` under
        ``config``, an :class:`~repro_torch.oocore.OocoreConfig`, or the
        stored one), not re-stacked."""
        if blocksets is None:
            blocksets = self._blocksets
            if blocksets is None:
                raise RuntimeError(
                    "ShardedDaemon.remesh called before bind_shards")
        if config is not None or self._oocore_config is not None:
            return self.bind_super_shards(blocksets, mesh=mesh,
                                          axis=self.axis, config=config)
        return self.bind_shards(blocksets, mesh=mesh, axis=self.axis)

    def run_all_shards(self, state, aux, active=None, *, run_mask=None,
                       residual=None, stacked=None, live_rows=None):
        """Gen + Merge for ALL shards in one pass on the device.

        Args:
          state, aux: the (N, K) / (N, A) vertex table, device tensors.
          active: the frontier for skipping — an (N,) bool shared by every
            device, an (m, N) bool whose row g is device g's private
            frontier (the async loop's backlog), or None to run every
            block (programs that are not frontier-driven).
          run_mask: (m,) bool, host values (a tensor is brought to the
            host): the async predict half's verdict.  A False device — or,
            with a per-device ``active``, one whose row is empty — runs no
            gather, Gen or Merge: it contributes the monoid identity with
            zero counts and zero blocks run, or its priority bucket's
            partial when :meth:`configure_buckets` armed them.  The other
            devices run in one pass per maximal run of consecutive ones.
          residual: (N,) f32 per-vertex last state change, the buckets'
            score (needed when they are armed and ``run_mask`` is given).
          stacked: ``self.stacked`` as the fused loop threads it through.
          live_rows: (m,) host bools, which rows of a per-device
            ``active`` hold a source, as the caller already fetched them;
            without it they are read from ``active`` (one device→host
            read).
        Returns:
          ``(partials (m, N, K), counts (m, N) int32, blocks_run (S,)
          int32)`` on the device: partial g folds the shards of logical
          device g; blocks_run counts tiles for ``kernel="cuda"``.
        """
        st = self._stacked if stacked is None else stacked
        if st is None:
            raise RuntimeError(
                "ShardedDaemon.run_all_shards called before bind_shards")
        m = self.m
        if run_mask is None:
            return self._body(state, aux, active, st, 0, m)
        run = _host_bools(run_mask, m, "run_mask")
        per_device = active is not None and active.dim() == 2
        if per_device:
            rows = _host_bools(active.any(dim=1) if live_rows is None
                               else live_rows, m, "live_rows")
            run = [r and a for r, a in zip(run, rows)]
        bucket = st.get("bucket")
        has_bucket = (bucket is not None and self._bucket_k > 0
                      and self.program.monoid.idempotent)
        if has_bucket and residual is None:
            raise ValueError("run_all_shards with armed buckets needs the "
                             "per-vertex residual for the bucket scores")
        if self.instrument:
            self.gen_invocations += sum(run)
            if has_bucket:
                self.bucket_invocations += m - sum(run)
        if all(run):
            return self._body(state, aux, active, st, 0, m)
        per = self.num_shards // m
        parts, g = [], 0
        while g < m:
            h = g + 1
            if run[g]:
                while h < m and run[h]:
                    h += 1
                parts.append(self._body(state, aux, active, st, g, h))
            else:
                parts.append(self._held(state, aux, active, residual,
                                        bucket if has_bucket else None, g,
                                        per))
            g = h
        return tuple(torch.cat(x) for x in zip(*parts))

    def _held(self, state, aux, active, residual, bucket, g, per):
        """A held device g's output: its bucket's partial, or the identity,
        with zero blocks run."""
        prog, n = self.program, self.n
        dev = state.device
        blocks = torch.zeros(per, dtype=torch.int32, device=dev)
        if bucket is None:
            return (torch.full((1, n, prog.state_width),
                               prog.monoid.identity, dtype=torch.float32,
                               device=dev),
                    torch.zeros((1, n), dtype=torch.int32, device=dev),
                    blocks)
        scores = residual
        if active is not None:
            act = active[g] if active.dim() == 2 else active
            scores = torch.where(act, residual, torch.full_like(residual,
                                                                -1.0))
        sl = slice(g * per, (g + 1) * per)
        agg, cnt = bucket_partials(
            state, aux, scores, bucket["ptr"][sl], bucket["dst"][sl],
            bucket["w"][sl], program=prog, k=self._bucket_k,
            cap=self._bucket_cap, num_vertices=n)
        return agg[None], cnt[None], blocks

    def _body(self, state, aux, active, st, g0, g1):
        """The shard body of devices g0 … g1 − 1: one pass over views of
        their contiguous shards' stacked tensors."""
        per = self.num_shards // self.m
        sl = slice(g0 * per, g1 * per)
        act = active
        if active is not None and active.dim() == 2:
            act = active[g0:g1]
        if self.kernel == "cuda":
            c = {k: v[sl] for k, v in st["csr"].items()}
            return self._csr_body(state, aux, act, c, g1 - g0)
        return self._block_body(state, aux, act,
                                {k: st[k][sl]
                                 for k in _BLOCK_FIELDS + ("gsrc",)},
                                g1 - g0)

    def _block_body(self, state, aux, act, st, groups):
        """Block program over the given stacked blocks + the combine into
        ``groups`` devices.  A block with no active source contributes
        nothing this iteration, the host path's block granularity."""
        vids, emask = st["vids"], st["emask"]
        s, nb, vb = vids.shape
        b = emask.shape[2]
        if act is not None:
            blk_active = (_frontier_at(act, st["gsrc"]) & emask).any(dim=2)
            emask = emask & blk_active[..., None]
        else:
            blk_active = emask.any(dim=2)
        vids = vids.reshape(s * nb, vb)
        partial, counts = self.block_fn(
            state, aux, vids, st["lsrc"].reshape(s * nb, b),
            st["ldst"].reshape(s * nb, b),
            st["weights"].reshape(s * nb, b, 1), emask.reshape(s * nb, b))
        n = self.n
        ids = vids.long()
        if groups > 1:  # device g's blocks fold into rows g·N + vertex id
            ids = ids + (torch.arange(s * nb, device=ids.device)
                         // (s // groups * nb) * n)[:, None]
        agg, cnt = make_combine_fn(self.program, groups * n)(partial, counts,
                                                             ids)
        return (agg.reshape(groups, n, -1), cnt.reshape(groups, n),
                blk_active.sum(dim=1, dtype=torch.int32))

    def _csr_body(self, state, aux, act, c, groups):
        """The CSR aggregation over the given stacked tiles (ONE
        ``csr_tile`` launch for a tiled config) + the combine into
        ``groups`` devices (inside ``csr_aggregate_groups``)."""
        em = (c["emask"] & _frontier_at(act, c["gsrc"]) if act is not None
              else c["emask"])
        tiles_run = em.any(dim=2).sum(dim=1, dtype=torch.int32)
        csr = {k: v.flatten(0, 1) for k, v in c.items()}
        csr["emask"] = em.flatten(0, 1)
        agg, cnt = kops.csr_aggregate_groups(
            state, aux, csr, program=self.program, num_vertices=self.n,
            config=self._csr_config, groups=groups)
        return agg, cnt, tiles_run

    # -- masked execution (MaskCapableDaemon) -----------------------------
    def configure_buckets(self, k: int, cap: int = 32):
        """Arms the vertex-level priority buckets of the masked path.

        With ``k > 0`` a held device still runs the out-edges of its
        top-``k`` residual vertices, at most ``cap`` each
        (:func:`~repro_torch.kernels.edge_block.bucket_partials`).  Each
        shard's src-sorted adjacency is built on the host once per binding
        and stacked beside the block tensors, in the same ``stacked`` dict.
        Only idempotent monoids qualify — the bucket messages are folded
        into the held copy, which must tolerate duplicates — so ``k`` is
        forced to 0 otherwise.  Returns self.
        """
        k, cap = int(k), int(cap)
        if cap <= 0:
            raise ValueError(f"bucket cap must be positive, got {cap}")
        if self.program is not None:  # bound
            k = min(k, self.n) if self.program.monoid.idempotent else 0
        self._bucket_k, self._bucket_cap = k, cap
        st = self._stacked
        if st is not None:
            if k > 0 and self._blocksets and "bucket" not in st:
                from repro_torch.graph.compaction import src_adjacency

                adjs = [src_adjacency(*_live_edges(bs), self.n)
                        for bs in self._blocksets]
                ep = max(1, max(a[1].shape[0] for a in adjs))

                def place(arrs):
                    return torch.from_numpy(np.stack(arrs)).to(self.device)

                def padded(i):
                    return [np.pad(a[i], (0, ep - a[i].shape[0]))
                            for a in adjs]

                # in place: a loop holding this dict sees the new field
                st["bucket"] = {"ptr": place([a[0] for a in adjs]),
                                "dst": place(padded(1)),
                                "w": place(padded(2))}
            elif k == 0:
                st.pop("bucket", None)
        return self

    def reset_counters(self):
        """Zeroes the instrumentation counters (``instrument=True``)."""
        self.gen_invocations = 0
        self.bucket_invocations = 0


# the BlockSet fields CSR tiles are compacted from (with the block size)
_EDGE_FIELDS = ("gsrc", "gdst", "weights", "emask")


def _edges_key(bs: BlockSet):
    """The tile caches' key: a BlockSet's edge arrays.  A BlockSet whose
    vertex blocks were only widened (``core.blocks.widen_vblocks``) shares
    them, and so its compacted tiles."""
    return id(bs.gsrc)


def _same_edges(a: BlockSet, b: BlockSet) -> bool:
    return a is b or (a.block_size == b.block_size and all(
        getattr(a, f) is getattr(b, f) for f in _EDGE_FIELDS))


def _host_bools(x, m: int, name: str) -> list:
    """(m,) bools as a host list (a tensor is brought to the host)."""
    vals = x.tolist() if hasattr(x, "tolist") else list(x)
    if len(vals) != m:
        raise ValueError(f"{name} has {len(vals)} entries, expected {m}")
    return [bool(v) for v in vals]


def _frontier_at(act, gsrc):
    """``act[gsrc]`` for a shared (N,) frontier; for an (m, N) per-device
    one each of the S stacked shards reads its device's row (device g owns
    shards g·S/m … (g+1)·S/m − 1)."""
    if act.dim() == 1:
        return act[gsrc]
    s = gsrc.shape[0]
    dev = torch.arange(s, device=gsrc.device) // (s // act.shape[0])
    return act[dev.view(-1, *([1] * (gsrc.dim() - 1))), gsrc]


# the tile fields the sharded CSR body reads; ``gdst`` (S·nt·ET int32: 72
# MB at scale 20) is stacked beside them only when the chosen merge is
# flat, the one merge that reads it
_CSR_FIELDS = ("rows", "seg", "lsrc", "svids", "w", "emask", "gsrc")


def _host_block_stacks(blocksets, nb_max=None) -> dict:
    """Every shard's block arrays stacked on a leading shard axis, padded
    to a common block count (``nb_max``, by default the largest) with
    dead blocks — host numpy."""
    if nb_max is None:
        nb_max = max(bs.num_blocks for bs in blocksets)

    def stack(field, fill=0):
        arrs = []
        for bs in blocksets:
            a = getattr(bs, field)
            pad = nb_max - a.shape[0]
            if pad:
                a = np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            arrs.append(a)
        return np.stack(arrs)

    return {"vids": stack("vids"), "lsrc": stack("lsrc"),
            "ldst": stack("ldst"), "weights": stack("weights"),
            "emask": stack("emask", fill=False), "gsrc": stack("gsrc")}


def _stacked_field(st: dict, name: str):
    """Resolves a flat field name ("vids", "csr/rows") in a stacked dict."""
    if name.startswith("csr/"):
        return st.get("csr", {}).get(name[4:])
    return st.get(name)


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
register_daemon("sharded", ShardedDaemon)
register_daemon("pipelined", PipelinedDaemon)
register_daemon("naive", NaiveDaemon)
