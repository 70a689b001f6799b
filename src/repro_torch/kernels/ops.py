"""Public wrappers around the port's kernels (the JAX package's
``kernels/ops.py``).  What the JAX package keeps outside Pallas is plain
PyTorch here too: the vertex-table gathers before a graph kernel and the
cross-tile combine after it, the CSR aggregation's flat merge, and the
SSD's cross-chunk recurrence.  The kernel bodies are the CUDA kernels of
``kernels/edge_block.py``, ``kernels/flash_attention.py`` and
``kernels/ssd_scan.py`` (their plain versions on CPU tensors).
``impl="cuda"`` takes the place of the JAX package's ``impl="pallas"``;
``impl="reference"`` runs the oracles of ``kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.autotune import CSRConfig
from repro_torch.kernels.edge_block import (_gather_rows, _merge, csr_tile,
                                            edge_block)
from repro_torch.kernels.ssd_scan import ssd_chunk


def _check_impl(impl: str) -> None:
    if impl != "cuda":
        raise ValueError(f"impl must be 'cuda' or 'reference', got {impl!r}")


def _pad_aux(state, aux):
    # zero-width aux: the kernels take an aux column to keep one signature
    if aux.shape[1] == 0:
        return torch.zeros((state.shape[0], 1), dtype=state.dtype,
                           device=state.device)
    return aux


# --------------------------------------------------------------------------
# edge block
# --------------------------------------------------------------------------
def edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask, *,
                         program: VertexProgram, impl: str = "cuda"):
    """Agent-side wrapper: gathers the paired vertex blocks, then runs the
    edge-block kernel over all blocks (``impl="reference"``: the oracle)."""
    if impl == "reference":
        return ref.edge_block_aggregate(state, aux, vids, lsrc, ldst, w,
                                        emask, program=program)
    _check_impl(impl)
    aux = _pad_aux(state, aux)
    vids = vids.long()
    return edge_block(state[vids], aux[vids], lsrc, ldst,
                      w.to(torch.float32), emask.to(torch.float32),
                      program=program)


# --------------------------------------------------------------------------
# CSR tile aggregation
# --------------------------------------------------------------------------
def _csr_tiles_torch(vsrc, vaux, rowst, lsrc, seg, w, emask, *,
                     program: VertexProgram, merge: str, gather: str):
    """The CSR-tile kernel's plain twin batched over tiles (the JAX
    package's ``_csr_tiles_xla``), with its sorted and one-hot merges and
    its take and one-hot gathers.  It serves the CPU and the tests: on a
    tensor that is not on the CPU it raises, so it never stands in for the
    kernel on the card."""
    if vsrc.device.type != "cpu":
        raise ValueError("the tiled plain twin (lowering='torch') runs on "
                         f"CPU tensors only, got {vsrc.device}; the card "
                         "runs lowering='cuda' or merge='flat'")
    monoid = program.monoid
    k = program.state_width
    t, st, _ = vsrc.shape
    rt = rowst.shape[1]
    et = lsrc.shape[1]
    lsrc, seg = lsrc.long(), seg.long()
    if gather == "onehot":
        soh = (lsrc[..., None] == torch.arange(st)).to(torch.float32)
        roh = (seg[..., None] == torch.arange(rt)).to(torch.float32)
        s = torch.einsum("tes,tsk->tek", soh, vsrc)
        sa = torch.einsum("tes,tsa->tea", soh, vaux)
        d = torch.einsum("ter,trk->tek", roh, rowst)
    else:
        s, sa = _gather_rows(vsrc, lsrc), _gather_rows(vaux, lsrc)
        d = _gather_rows(rowst, seg)
    msgs = program.msg_gen(
        s.reshape(t * et, k), d.reshape(t * et, k), w.reshape(t * et, 1),
        sa.reshape(t * et, -1))
    if merge == "sorted":
        # seg is sorted tile-local: one flat sorted-segment reduce
        segg = seg + torch.arange(t)[:, None] * rt
        partial, counts = _merge(program, msgs, emask.reshape(-1),
                                 segg.reshape(-1), t * rt)
        return partial.reshape(t, rt, k), counts.reshape(t, rt)
    # merge == "onehot": the matrix-unit form of the JAX package
    msgs = msgs.reshape(t, et, k)
    msgs = torch.where(emask[..., None], msgs,
                       torch.full_like(msgs, monoid.identity))
    live = (seg[..., None] == torch.arange(rt)) & emask[..., None]
    if monoid.name == "sum":
        partial = torch.einsum("ter,tek->trk", live.to(torch.float32), msgs)
    elif monoid.name in ("min", "max", "or"):
        sel = live.transpose(1, 2)  # (T, RT, ET)
        red = torch.amin if monoid.name == "min" else torch.amax
        partial = torch.stack(
            [red(torch.where(sel, msgs[..., i][:, None, :],
                             torch.full_like(msgs[..., i][:, None, :],
                                             monoid.identity)), dim=2)
             for i in range(k)], dim=2)
    else:
        raise ValueError(
            f"monoid {monoid.name!r} has no CSR merge rule; known: "
            "['max', 'min', 'or', 'sum']")
    return partial, live.sum(dim=1, dtype=torch.int32)


def _dst_rows(program: VertexProgram, state, idx):
    """The dst rows ``msg_gen`` is handed: ``state[idx]`` for a program
    without a ``gen_op``, whose ``msg_gen`` may read them.  A program with
    one computes the kernels' message function, which reads no dst row, so
    a broadcast view of the same shape stands in for the gather on every
    device."""
    if program.gen_op is None:
        return state[idx]
    return state.new_zeros(()).expand(*idx.shape, state.shape[1])


def csr_aggregate_groups(state, aux, csr: dict, *, program: VertexProgram,
                         num_vertices: int, config: CSRConfig,
                         groups: int = 1):
    """:func:`csr_aggregate` with the T tiles split into ``groups``
    contiguous runs of T/groups tiles, each folded into its own aggregate
    (the sharded daemon's m logical devices).  One kernel launch covers
    all T tiles; the combine (or the flat reduce) folds group g's rows
    into rows g·N … g·N + N − 1.

    Returns:
      agg (groups, N, K) f32, cnt (groups, N) i32.
    """
    monoid = program.monoid
    k = program.state_width
    n = num_vertices
    t = csr["emask"].shape[0]
    if groups < 1 or t % groups:
        raise ValueError(f"{t} tiles do not split into {groups} groups")
    aux = _pad_aux(state, aux)
    emask = csr["emask"]
    w = csr["w"].to(torch.float32)

    def grouped(idx):
        """(T, X) vertex ids → flat ids of their group's rows, g·N + id."""
        if groups > 1:
            idx = idx + (torch.arange(t, device=idx.device) // (t // groups)
                         * n)[:, None]
        return idx.reshape(-1)

    if config.merge == "flat":
        gsrc = csr["gsrc"].long().reshape(-1)
        gdst = csr["gdst"].long()
        emf = emask.reshape(-1)
        msgs = program.msg_gen(state[gsrc],
                               _dst_rows(program, state, gdst.reshape(-1)),
                               w.reshape(-1, 1), aux[gsrc])
        msgs = torch.where(emf[:, None], msgs,
                           torch.full_like(msgs, monoid.identity))
        # dead and padded slots carry dst 0: they merge the identity into
        # vertex 0, a no-op (the JAX package's convention)
        dst = grouped(gdst)
        agg = monoid.segment_reduce(msgs, dst, groups * n)
        cnt = segment_sum(emf.to(torch.int32), dst, groups * n)
    else:
        svids = csr["svids"].long()
        rows = csr["rows"].long()
        vsrc = state[svids]            # (T, ST, K) compact src blocks
        vaux = aux[svids]
        rowst = _dst_rows(program, state, rows)  # (T, RT, K) row blocks
        if config.lowering == "cuda":
            partial, counts = csr_tile(vsrc, vaux, rowst, csr["lsrc"],
                                       csr["seg"], w,
                                       emask.to(torch.float32),
                                       program=program)
        else:
            partial, counts = _csr_tiles_torch(
                vsrc, vaux, rowst, csr["lsrc"], csr["seg"], w, emask,
                program=program, merge=config.merge, gather=config.gather)
        # cross-tile combine: finishes split hub rows and folds every
        # tile's row partials into its group's aggregate
        rows = grouped(rows)
        agg = monoid.segment_reduce(partial.reshape(-1, k), rows, groups * n)
        cnt = segment_sum(counts.reshape(-1), rows, groups * n)
    agg = torch.where((cnt > 0)[:, None], agg,
                      torch.full_like(agg, monoid.identity))
    return agg.reshape(groups, n, k), cnt.reshape(groups, n)


def csr_aggregate(state, aux, csr: dict, *, program: VertexProgram,
                  num_vertices: int, config: CSRConfig):
    """Fused gather + Gen + segmented Merge over CSR tiles → (N, K) agg.

    Args:
      state (N, K) f32, aux (N, A) f32 — the shard vertex table.
      csr: dict of per-tile tensors with leading tile axis T (the
        ``CSRTileSet.arrays()`` layout): rows (T, RT), seg/lsrc/gsrc/gdst
        (T, ET), svids (T, ST), w (T, ET, 1), emask (T, ET) bool.
        ``emask`` may already carry per-edge frontier filtering.
      config: a :class:`~repro_torch.kernels.autotune.CSRConfig` (the
        tiles were cut with its edge tile).  ``merge="flat"`` forms no
        tile partials: one segment reduce by global dst (``gdst``) straight
        to (N, K).  The tiled merges run the CSR-tile kernel
        (``lowering="cuda"``) or its plain twin (``"torch"``, CPU tensors
        only), then the cross-tile combine.
    Returns:
      agg (N, K) f32 — merged messages; vertices with no message read the
      monoid identity.  cnt (N,) i32 — messages per vertex.
    """
    agg, cnt = csr_aggregate_groups(state, aux, csr, program=program,
                                    num_vertices=num_vertices, config=config)
    return agg[0], cnt[0]


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, impl: str = "cuda",
                    block_q: int = 128, block_k: int = 128):
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) → (B, Hq, S, D) in q's dtype.

    ``block_q``/``block_k`` are checked as the JAX kernel checks them (S
    must divide into ``min(block, S)`` blocks), so the same calls are
    refused; the CUDA kernel tiles by its own 64 rows and its result does
    not depend on them."""
    if impl == "reference":
        return ref.flash_attention(q, k, v, causal=causal)
    _check_impl(impl)
    if q.dim() == 4:
        s = q.shape[2]
        for name, blk in (("block_q", block_q), ("block_k", block_k)):
            if blk < 1 or s % min(blk, s) != 0:
                raise ValueError(f"S={s} must divide into {name}={blk} "
                                 "blocks")
    return fa.flash_attention(q, k, v, causal=causal)


# --------------------------------------------------------------------------
# SSD scan (Mamba2)
# --------------------------------------------------------------------------
def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 64, impl: str = "cuda",
             return_final_state: bool = False):
    """Full SSD: within-chunk kernel + cross-chunk recurrence.

    x (B, S, H, P), dt (B, S, H), a (H,), b_mat/c_mat (B, S, G, N) with
    H % G == 0.  Returns y (B, S, H, P) in x's dtype.  The kernel reads B
    and C by group; only the (B, NC, L, G, N) views of them are formed.
    ``return_final_state`` also returns the (B, H, N, P) float32 state
    after the last chunk (the prefill → decode handoff).
    """
    if impl == "reference":
        return ref.ssd_scan_chunked_ref(x, dt, a, b_mat, c_mat, chunk=chunk,
                                        return_final_state=return_final_state)
    _check_impl(impl)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    ref.check_chunk(s, chunk)
    nc = s // chunk

    def chunks(t):
        return t.float().contiguous().reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = map(chunks, (x, dt, b_mat, c_mat))
    y_local, states, decays, gates = ssd_chunk(
        xc, dtc, a.float().contiguous(), bc, cc)

    # Cross-chunk recurrence (the agent-side combine): the state carried
    # into each chunk, stacked (no in-place write, so it differentiates).
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    carries = []
    for c in range(nc):
        carries.append(hstate)
        hstate = hstate * decays[:, c, :, None, None] + states[:, c]
    carry_in = torch.stack(carries, dim=1)  # (B, NC, H, N, P)

    # y_carry[t] = gate_t · C_t · carry_in, with C read by group
    r = h // g
    y_carry = torch.einsum(
        "bclgn,bcgrnp->bclgrp", cc, carry_in.reshape(bsz, nc, g, r, n, p))
    y_carry = y_carry * gates.reshape(bsz, nc, chunk, g, r)[..., None]
    y = (y_local + y_carry.reshape(bsz, nc, chunk, h, p)).reshape(bsz, s, h, p)
    if return_final_state:
        return y.to(x.dtype), hstate
    return y.to(x.dtype)
