"""Plain PyTorch oracles for the port's kernels (the JAX package's
``kernels/ref.py``): the edge-block daemon program, attention and the
Mamba2 SSD scan, function for function with the same shapes and dtype
rules."""
from __future__ import annotations

import torch

from repro_torch.core.template import VertexProgram
from repro_torch.kernels.edge_block import edge_block_plain
from repro_torch.kernels.flash_attention import flash_attention_plain


def edge_block_aggregate(state, aux, vids, lsrc, ldst, w, emask, *,
                         program: VertexProgram):
    """Per-block Gen + block-local Merge over the vertex table.

    Args:
      state (N, K) f32, aux (N, A) f32 — the shard vertex table.
      vids  (nb, VB) i32 — vertex blocks (global ids).
      lsrc, ldst (nb, B) i32 — block-local edge endpoints.
      w (nb, B, 1) f32, emask (nb, B) bool.
    Returns:
      partial (nb, VB, K) f32 — per-block merged messages (monoid), the
      identity at message-free slots.
      counts  (nb, VB) i32    — messages received per vertex slot.
    """
    vids = vids.long()
    return edge_block_plain(state[vids], aux[vids], lsrc, ldst, w,
                            emask.float(), program=program)


# --------------------------------------------------------------------------
# flash_attention: causal multi-head attention forward
# --------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Oracle: plain softmax attention.

    q (B, Hq, S, D); k, v (B, Hkv, S, D) with Hq % Hkv == 0 (GQA).
    Returns (B, Hq, S, D) in q's dtype.
    """
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


# --------------------------------------------------------------------------
# ssd: Mamba2 SSD (state-space duality)
# --------------------------------------------------------------------------
def expand_groups(m: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) → (..., H, N): head ``i`` reads group ``i // (H // G)``."""
    return torch.repeat_interleave(m, h // m.shape[-2], dim=-2)


def ssd_scan_reference(x, dt, a, b_mat, c_mat, *, chunk: int = 64):
    """Oracle: sequential SSD recurrence (naive scan over time).

    Mamba2 SSD per head:  h_t = exp(a*dt_t) * h_{t-1} + dt_t * B_t x_t^T
                          y_t = C_t h_t
    Shapes: x (B, S, H, P), dt (B, S, H) >0, a (H,) <0,
            b_mat/c_mat (B, S, G, N) with H % G == 0.
    Returns y (B, S, H, P).  ``chunk`` is unused (the JAX signature).
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    bh = expand_groups(b_mat, h).float()
    ch = expand_groups(c_mat, h).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])  # (B,H)
        hstate = hstate * decay[..., None, None] + (
            (dtf[:, t, :, None] * bh[:, t])[..., :, None]
            * xf[:, t][..., None, :])  # (B,H,N,P)
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], hstate))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunk_local(x, dt, a, b_mat, c_mat):
    """Oracle for the *within-chunk* quadratic part of SSD (no carry-in).

    Per chunk of length L: y_t = sum_{s<=t} C_t·B_s (prod_{r in (s,t]}
    decay_r) dt_s x_s — the "attention-like" dual form. Inputs are per-chunk:
    x (B, L, H, P), dt (B, L, H), a (H,), b_mat/c_mat (B, L, H, N) (heads
    already expanded). Returns (y (B, L, H, P), state_out (B, H, N, P),
    decay_total (B, H)).
    """
    l = x.shape[1]
    logd = a[None, None, :] * dt  # (B,L,H) log decay per step
    cum = torch.cumsum(logd, dim=1)  # (B,L,H) inclusive
    # L_mat[t,s] = exp(cum[t]-cum[s]) for s<=t  (decay product over (s, t])
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,L,L,H)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    # double where: exp(diff) overflows for masked (s>t) entries — zero
    # diff in the dead region first
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    diff = torch.where(causal, diff, zero)
    gate = torch.where(causal, torch.exp(diff), zero)
    cb = torch.einsum("blhn,bshn->blsh", c_mat, b_mat)  # (B,L,S,H)
    w = cb * gate * dt[:, None, :, :]  # weight for source s → target t
    y = torch.einsum("blsh,bshp->blhp", w, x)
    # carry-out state: sum_s decay(s..L] dt_s B_s x_s^T
    tail = torch.exp(cum[:, -1:, :] - cum)  # (B,L,H) decay from s+1..L
    sb = (dt * tail)[..., None] * b_mat  # (B,L,H,N)
    state = torch.einsum("blhn,blhp->bhnp", sb, x)
    return y.to(x.dtype), state, torch.exp(cum[:, -1, :])


def check_chunk(s: int, chunk: int) -> None:
    """The chunked SSD needs the sequence to split into whole chunks."""
    if chunk < 1 or s % chunk != 0:
        raise ValueError(f"seq must divide by chunk: S={s}, chunk={chunk}")


def ssd_scan_chunked_ref(x, dt, a, b_mat, c_mat, *, chunk: int = 64,
                         return_final_state: bool = False):
    """Chunked SSD in plain PyTorch (within-chunk dual form + cross-chunk
    scan).  Must equal :func:`ssd_scan_reference`; the CUDA kernel
    accelerates the within-chunk part.  ``return_final_state`` additionally
    returns the (B, H, N, P) state after the last position (prefill →
    decode handoff)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    check_chunk(s, chunk)
    nc = s // chunk
    bh = expand_groups(b_mat, h).float()
    ch = expand_groups(c_mat, h).float()
    af = a.float()

    def chunks(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = map(chunks, (x.float(), dt.float(), bh, ch))
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xi, dti, bi, ci = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        y_local, state_out, decay_tot = ssd_chunk_local(xi, dti, af, bi, ci)
        # contribution of the carry-in state to each position in the chunk
        carry_gate = torch.exp(torch.cumsum(af[None, None, :] * dti, dim=1))
        y_carry = torch.einsum("blhn,bhnp->blhp",
                               ci * carry_gate[..., None], hstate)
        hstate = hstate * decay_tot[..., None, None] + state_out
        ys.append(y_local + y_carry)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p).to(x.dtype)
    if return_final_state:
        return y, hstate
    return y
