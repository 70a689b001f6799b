"""Mixture-of-Experts FFN, as in the JAX package's ``models/moe.py``.

Dispatch is gather-based (sort → group → gather), never a scatter:

  1. router logits → top-k experts and normalized combine weights per
     token, and the Switch load-balance loss;
  2. the flat (T·k,) expert assignments are sorted (stably); expert e owns
     the contiguous run [start_e, start_{e+1});
  3. the (E, C) dispatch index map gathers tokens into an (E, C, D) buffer
     (C = capacity; overflow assignments are dropped, their weight zeroed);
  4. one batched matmul per projection over the expert dim;
  5. the inverse gather pulls each token's k expert outputs back and sums
     them weighted by the gates.

On one card ``moe_ffn`` takes this local path always.  The JAX package's
``_moe_shardmap`` — the expert-data-transposed layout over a (data, model)
mesh, experts on the model axis and a psum in the combine — is the layout
across cards, ROADMAP Queue A item 13d's: under an
``activation_sharding`` context over a ``dist.sharding.RankMesh``
``moe_ffn`` raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L


def moe_leaves(cfg) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    return {
        # the router's logits are float32 (the JAX package keeps it so)
        "router": L.Leaf((d, e), (shd.FSDP, None),
                         ("normal", float(1 / np.sqrt(d))),
                         keep_float32=True),
        "wi": L.normal((e, d, f), (shd.EXPERT, shd.FSDP, None),
                       1 / np.sqrt(d)),
        "wg": L.normal((e, d, f), (shd.EXPERT, shd.FSDP, None),
                       1 / np.sqrt(d)),
        "wo": L.normal((e, f, d), (shd.EXPERT, None, shd.FSDP),
                       1 / np.sqrt(f)),
    }


def capacity_for(tokens: int, cfg) -> int:
    c = int(np.ceil(tokens * cfg.experts_per_token * cfg.capacity_factor
                    / cfg.num_experts))
    return max(8, ((c + 7) // 8) * 8)  # padded to 8


def _route(p, xf, cfg):
    """Router: top-k experts, normalized gates and the Switch aux loss."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t = xf.shape[0]
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the k largest, ties toward the lower index — a stable
    # descending sort gives the same order
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # assignments per expert: float32 ones added by index, exact below 2^24
    # and on every device, the meta device included (where bincount is not)
    flat = expert_ids.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=xf.device)) / (t * k)
    aux = e * torch.sum(me * ce)
    return gate_vals, expert_ids, aux


def _dispatch_local(xf, ids, cap: int, e: int, k: int):
    """(T, D) tokens and (T, k) expert ids → the (E, C, D) buffer and the
    combine metadata (each assignment's rank in its expert's run, and
    whether it is kept)."""
    t = xf.shape[0]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e + 1, device=xf.device, dtype=flat.dtype))
    slot = group_start[:-1, None] + torch.arange(cap, device=xf.device)
    valid = slot < group_start[1:, None]
    token_of_slot = order[torch.clamp(slot, 0, t * k - 1)] // k
    xe = xf[token_of_slot] * valid[..., None].to(xf.dtype)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=xf.device)
    rank = inverse - group_start[flat]
    return xe, rank, rank < cap


def _combine_local(ye, ids, gates, rank, kept, d: int):
    """Inverse gather and the gate-weighted sum."""
    t, k = ids.shape
    cap = ye.shape[1]
    yk = ye[ids.reshape(-1), torch.clamp(rank, 0, cap - 1)]
    yk = yk * kept[:, None].to(ye.dtype)
    return torch.sum(yk.reshape(t, k, d)
                     * gates.reshape(t, k, 1).to(ye.dtype), dim=1)


def _expert_compute(p, xe, cfg):
    dt = xe.dtype
    h = torch.bmm(xe, L.cast(p["wi"], dt))
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.bmm(xe, L.cast(p["wg"], dt))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, L.cast(p["wo"], dt))


def moe_ffn(p, x, cfg, *, return_aux: bool = False, stats=None):
    """x (B, S, D) → (B, S, D) [, the aux-loss scalar].  ``stats``, a dict
    if given, receives the assignments made and those dropped for want of
    capacity (as 0-d tensors)."""
    ctx = shd.active_context()
    if ctx is not None and isinstance(ctx[0], shd.RankMesh):
        raise NotImplementedError(
            "the MoE's expert layout across ranks is not ported to "
            "repro_torch yet (ROADMAP Queue A item 13)")
    bsz, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = bsz * s
    xf = x.reshape(t, d)
    gate_vals, expert_ids, aux = _route(p, xf, cfg)
    cap = capacity_for(t, cfg)
    xe, rank, kept = _dispatch_local(xf, expert_ids, cap, e, k)
    if stats is not None:
        stats["assignments"] = stats.get("assignments", 0) + kept.numel()
        stats["dropped"] = stats.get("dropped", 0) + (~kept).sum()
    ye = _expert_compute(p, xe, cfg)
    out = _combine_local(ye, expert_ids, gate_vals, rank, kept, d)
    out = out.reshape(bsz, s, d)
    if cfg.shared_expert:
        out = out + L.ffn(p["shared"], x, cfg.activation)
    if return_aux:
        return out, aux
    return out


def moe_dispatch_specs(cfg, mesh, rules):
    """The (E, C, D) buffer's logical axes — expert dim on the model axis,
    capacity on the data axis (for inspection)."""
    return (shd.EXPERT, shd.CAPACITY, None)
