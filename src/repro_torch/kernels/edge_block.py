"""The two GX-Plug graph kernels: wrappers over the CUDA C++ sources in
``csrc/`` and their plain PyTorch versions.

* :func:`edge_block` — the edge-block daemon program (``csrc/edge_block.cu``),
  replacing the TPU kernel ``src/repro/kernels/edge_block.py::edge_block_pallas``.
* :func:`csr_tile` — the fused CSR-tile daemon program (``csrc/csr_tile.cu``),
  replacing ``src/repro/kernels/edge_block.py::csr_tile_pallas``.

:func:`bucket_partials`, the async loop's priority buckets, is plain
PyTorch here as it is ``jnp`` in the JAX package: it is not a kernel.

Each wrapper checks device, dtype, shape and contiguity.  On CPU tensors it
runs the plain version (:func:`edge_block_plain`, :func:`csr_tile_plain`);
on CUDA tensors it launches the kernel or raises — there is no fallback.
Each wrapper counts its launches in a plain integer attribute
(``edge_block.launches``, ``csr_tile.launches``), incremented only where
the kernel is launched.  The kernels' bounds and design are in the notes at
the top of each ``.cu`` file; their times on the card are in PERF.md.
"""
from __future__ import annotations

import torch

from repro_torch.core.template import GEN_OPS, VertexProgram, segment_sum
from repro_torch.kernels import build

# Monoid name → the kernels' MonoidOp ("or" over {0,1} indicators is max).
_MONOID_OPS = {"sum": 0, "min": 1, "max": 2, "or": 2}
_MAX_K = 16  # csrc/common.cuh kMaxK


def _monoid_op(program: VertexProgram) -> int:
    try:
        return _MONOID_OPS[program.monoid.name]
    except KeyError:
        raise ValueError(
            f"monoid {program.monoid.name!r} has no kernel merge rule; "
            f"known: {sorted(_MONOID_OPS)}") from None


def _gen_op(program: VertexProgram) -> int:
    if program.gen_op not in GEN_OPS:
        raise ValueError(
            f"program {program.name!r} has gen_op={program.gen_op!r}; the "
            f"CUDA kernels implement {sorted(GEN_OPS)}")
    return GEN_OPS[program.gen_op]


def _check(named: dict, shapes: dict, device: torch.device,
           unread: tuple = ()) -> None:
    """Dtype, shape and device of every tensor; contiguity of every one the
    kernel reads (those not in ``unread``)."""
    for name, t in named.items():
        want_dtype, want_shape = shapes[name]
        if t.dtype != want_dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want_dtype}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want_shape}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if name not in unread and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[t, idx[t, e], :]`` for a (T, R, C) table and (T, E) idx."""
    return torch.take_along_dim(table, idx.long()[..., None], dim=1)


def _merge(program: VertexProgram, msgs, live, seg, num_segments: int):
    """Masked segmented merge → (partial, counts); message-free slots read
    the monoid identity (the kernels' contract)."""
    monoid = program.monoid
    msgs = torch.where(live[:, None], msgs,
                       torch.full_like(msgs, monoid.identity))
    partial = monoid.segment_reduce(msgs, seg, num_segments)
    counts = segment_sum(live.to(torch.int32), seg, num_segments)
    partial = torch.where((counts > 0)[:, None], partial,
                          torch.full_like(partial, monoid.identity))
    return partial, counts


# --------------------------------------------------------------------------
# edge block
# --------------------------------------------------------------------------
def edge_block_plain(vstate, vaux, lsrc, ldst, w, emask_f32, *,
                     program: VertexProgram):
    """Plain version of :func:`edge_block` (same signature and result as
    the JAX ``edge_block_pallas``)."""
    _monoid_op(program)
    nb, vb, k = vstate.shape
    b = lsrc.shape[1]
    s = _gather_rows(vstate, lsrc).reshape(nb * b, k)
    d = _gather_rows(vstate, ldst).reshape(nb * b, k)
    sa = _gather_rows(vaux, lsrc).reshape(nb * b, -1)
    msgs = program.msg_gen(s, d, w.reshape(nb * b, 1), sa)
    seg = (ldst.long() + torch.arange(nb, device=ldst.device)[:, None] * vb)
    partial, counts = _merge(program, msgs, emask_f32.reshape(-1) > 0,
                             seg.reshape(-1), nb * vb)
    return partial.reshape(nb, vb, k), counts.reshape(nb, vb)


def edge_block(vstate, vaux, lsrc, ldst, w, emask_f32, *,
               program: VertexProgram):
    """Per edge block: gather src rows of the paired vertex block, MSGGen,
    merge by block-local ``ldst``.

    Args: vstate (nb, VB, K) f32, vaux (nb, VB, A≥1) f32, lsrc/ldst (nb, B)
    i32, w (nb, B, 1) f32, emask_f32 (nb, B) f32.
    Returns: partial (nb, VB, K) f32, counts (nb, VB) i32.
    """
    mon = _monoid_op(program)
    nb, vb, k = vstate.shape
    a = vaux.shape[2]
    b = lsrc.shape[1]
    _check(dict(vstate=vstate, vaux=vaux, lsrc=lsrc, ldst=ldst, w=w,
                emask_f32=emask_f32),
           dict(vstate=(torch.float32, (nb, vb, k)),
                vaux=(torch.float32, (nb, vb, a)),
                lsrc=(torch.int32, (nb, b)), ldst=(torch.int32, (nb, b)),
                w=(torch.float32, (nb, b, 1)),
                emask_f32=(torch.float32, (nb, b))), vstate.device)
    if vstate.device.type == "cpu":
        return edge_block_plain(vstate, vaux, lsrc, ldst, w, emask_f32,
                                program=program)
    if vstate.device.type != "cuda":
        raise ValueError(f"edge_block runs on cuda or cpu, got {vstate.device}")
    gen = _gen_op(program)
    if not 1 <= k <= _MAX_K or a < 1:
        raise ValueError(f"edge_block needs 1 <= K <= {_MAX_K} and A >= 1, "
                         f"got K={k}, A={a}")
    partial = torch.empty((nb, vb, k), dtype=torch.float32,
                          device=vstate.device)
    counts = torch.empty((nb, vb), dtype=torch.int32, device=vstate.device)
    if nb * b * vb == 0:
        return partial.fill_(program.monoid.identity), counts.zero_()
    lib = build.library()
    # sum: the kernel merges messages and counts into float staging rows
    # (csrc/edge_block.cu) and writes partial and counts from them
    staging = (torch.empty(nb * vb * lib.gx_edge_block_staging_width(k),
                           dtype=torch.float32, device=vstate.device)
               if mon == _MONOID_OPS["sum"] else None)
    with torch.cuda.device(vstate.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gx_edge_block(
            vstate.data_ptr(), vaux.data_ptr(), lsrc.data_ptr(),
            ldst.data_ptr(), w.data_ptr(), emask_f32.data_ptr(),
            partial.data_ptr(), counts.data_ptr(),
            None if staging is None else staging.data_ptr(), nb, b, vb, k, a,
            gen, mon, float(program.monoid.identity), stream)
    build.check(rc, "gx_edge_block")
    edge_block.launches += 1
    return partial, counts


edge_block.launches = 0


# --------------------------------------------------------------------------
# CSR tile
# --------------------------------------------------------------------------
def csr_tile_plain(vsrc, vaux, rowst, lsrc, seg, w, emask_f32, *,
                   program: VertexProgram):
    """Plain version of :func:`csr_tile` (the JAX ``csr_tile_pallas`` and
    its XLA twin ``_csr_tiles_xla``): gathers by index and merges per tile
    by the sorted ``seg``."""
    _monoid_op(program)
    t, st, k = vsrc.shape
    rt = rowst.shape[1]
    et = lsrc.shape[1]
    s, sa = _gather_rows(vsrc, lsrc), _gather_rows(vaux, lsrc)
    d = _gather_rows(rowst, seg)
    msgs = program.msg_gen(s.reshape(t * et, k), d.reshape(t * et, k),
                           w.reshape(t * et, 1), sa.reshape(t * et, -1))
    segg = seg.long() + torch.arange(t, device=seg.device)[:, None] * rt
    partial, counts = _merge(program, msgs, (emask_f32 > 0).reshape(-1),
                             segg.reshape(-1), t * rt)
    return partial.reshape(t, rt, k), counts.reshape(t, rt)


def csr_tile(vsrc, vaux, rowst, lsrc, seg, w, emask_f32, *,
             program: VertexProgram):
    """Per dst-sorted CSR tile: gather src rows through ``lsrc``, MSGGen,
    merge by the sorted tile-local ``seg``.

    Args: vsrc (T, ST, K) f32, vaux (T, ST, A≥1) f32, rowst (T, RT, K) f32,
    lsrc/seg (T, ET) i32, w (T, ET, 1) f32, emask_f32 (T, ET) f32.
    Returns: partial (T, RT, K) f32, counts (T, RT) i32 — per-tile row
    partials; split hub rows still need the cross-tile combine.

    ``rowst`` (the tiles' dst rows) feeds only the plain version's
    ``msg_gen``, through a gather: no kernel message function reads dst
    state, so only its shape is used and it may be a broadcast view on
    either device.
    """
    mon = _monoid_op(program)
    t, st, k = vsrc.shape
    a = vaux.shape[2]
    rt = rowst.shape[1]
    et = lsrc.shape[1]
    _check(dict(vsrc=vsrc, vaux=vaux, rowst=rowst, lsrc=lsrc, seg=seg, w=w,
                emask_f32=emask_f32),
           dict(vsrc=(torch.float32, (t, st, k)),
                vaux=(torch.float32, (t, st, a)),
                rowst=(torch.float32, (t, rt, k)),
                lsrc=(torch.int32, (t, et)), seg=(torch.int32, (t, et)),
                w=(torch.float32, (t, et, 1)),
                emask_f32=(torch.float32, (t, et))), vsrc.device,
           unread=("rowst",))
    if vsrc.device.type == "cpu":
        return csr_tile_plain(vsrc, vaux, rowst, lsrc, seg, w, emask_f32,
                              program=program)
    if vsrc.device.type != "cuda":
        raise ValueError(f"csr_tile runs on cuda or cpu, got {vsrc.device}")
    gen = _gen_op(program)
    if not 1 <= k <= _MAX_K or a < 1:
        raise ValueError(f"csr_tile needs 1 <= K <= {_MAX_K} and A >= 1, "
                         f"got K={k}, A={a}")
    partial = torch.empty((t, rt, k), dtype=torch.float32, device=vsrc.device)
    counts = torch.empty((t, rt), dtype=torch.int32, device=vsrc.device)
    if t * et * rt * st == 0:
        return partial.fill_(program.monoid.identity), counts.zero_()
    lib = build.library()
    with torch.cuda.device(vsrc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gx_csr_tile(
            vsrc.data_ptr(), vaux.data_ptr(), lsrc.data_ptr(), seg.data_ptr(),
            w.data_ptr(), emask_f32.data_ptr(), partial.data_ptr(),
            counts.data_ptr(), t, et, st, rt, k, a, gen, mon,
            float(program.monoid.identity), stream)
    build.check(rc, "gx_csr_tile")
    csr_tile.launches += 1
    return partial, counts


csr_tile.launches = 0


# --------------------------------------------------------------------------
# priority buckets: Gen + Merge over the top-k residual vertices' out-edges,
# what a held device of the async loop still runs (JAX ``bucket_partials``)
# --------------------------------------------------------------------------
def bucket_partials(state, aux, scores, ptr, adst, aw, *,
                    program: VertexProgram, k: int, cap: int,
                    num_vertices: int):
    """Gen + Merge over the out-edges of the ``k`` highest-score vertices.

    Args:
      state (N, K), aux (N, A): the vertex table.
      scores (N,) f32: per-vertex priority (the last residual, with
        vertices outside the device's frontier set to -1); only strictly
        positive scores run.
      ptr (s_l, N+1) i32, adst (s_l, Ep) i32, aw (s_l, Ep) f32: the
        device's local shards' src-sorted adjacency
        (:func:`repro_torch.graph.compaction.src_adjacency`, stacked).
      cap: at most this many edges of each selected vertex (a hub's tail
        waits for the device's next full refresh; the backlog is never
        cleared by a bucket run, so capping loses nothing).
    Returns ``(agg (N, K) f32, cnt (N,) i32)``: the identity and 0 where no
    message landed, the partials contract of the shard bodies.  Only
    idempotent monoids may consume it (the messages are folded into a held
    copy that may already hold them).
    """
    monoid = program.monoid
    s_l, ep = adst.shape
    kk = program.state_width
    dev = state.device
    if ep == 0 or k <= 0:
        return (torch.full((num_vertices, kk), monoid.identity,
                           dtype=torch.float32, device=dev),
                torch.zeros(num_vertices, dtype=torch.int32, device=dev))
    # jax.lax.top_k's order: by score, the lower index first among equal
    # scores — a stable descending sort keeps exactly that order
    top_vals, top = torch.sort(scores, descending=True, stable=True)
    top_vals, top = top_vals[:k], top[:k]
    vmask = top_vals > 0.0
    ptr = ptr.long()
    start = ptr[:, top]                                  # (s_l, k)
    end = ptr[:, top + 1]
    idx = start[..., None] + torch.arange(cap, device=dev)
    valid = (idx < end[..., None]) & vmask[None, :, None]  # (s_l, k, cap)
    flat = idx.clamp(0, ep - 1).reshape(s_l, k * cap)
    d_flat = torch.take_along_dim(adst, flat, dim=1).reshape(-1).long()
    wts = torch.take_along_dim(aw, flat, dim=1).reshape(-1, 1)
    src_ids = top[None, :, None].expand(s_l, k, cap).reshape(-1)
    msgs = program.msg_gen(state[src_ids], state[d_flat], wts,
                           aux[src_ids])
    # dead slots merge into an extra segment that is sliced away
    vflat = valid.reshape(-1)
    seg = torch.where(vflat, d_flat, torch.full_like(d_flat, num_vertices))
    agg = monoid.segment_reduce(msgs, seg, num_vertices + 1)[:num_vertices]
    cnt = segment_sum(vflat.to(torch.int32), seg,
                      num_vertices + 1)[:num_vertices]
    agg = torch.where((cnt > 0)[:, None], agg,
                      torch.full_like(agg, monoid.identity))
    return agg.to(torch.float32), cnt
