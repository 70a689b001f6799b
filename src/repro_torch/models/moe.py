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

On one card, and under a ``dist.sharding.RankMesh`` (the graph path's
axis, which has no ``"model"`` axis), ``moe_ffn`` takes this local path.
Under an ``activation_sharding`` context over a ``dist.sharding.RankGrid``
it takes :func:`_moe_ranks`, the counterpart of the JAX package's
``_moe_shardmap``: the expert-data-transposed layout, chosen as JAX's
``moe_ffn`` chooses it.  Rank (d, r) holds experts [r·E/mp, (r+1)·E/mp)
and the tokens of its data shard; it dispatches its own tokens (capacity
per data shard), computes its experts, combines the assignments it owns
and sums the combine over its data row (``reduce_from_model``), the one
collective JAX's psum is.  The tokens and gates enter through
``copy_to_model``, so their gradient is summed over the row.  The aux
loss is the global batch's, as JAX computes it before its ``shard_map``.
The router (FSDP, None) and the experts' FSDP dim are gathered over data
before use (``layers.use``).  Under ``"fsdp"``, where the rows split over
``model`` too, a rank routes its own tokens and the row's are gathered
over ``model`` (the data shard's, as JAX's layout takes them); it keeps
its own rows of the output.
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


def _route(p, xf, cfg, grid=None, t=None):
    """Router: top-k experts, normalized gates and the Switch aux loss.
    With ``grid`` the rank's tokens are its shard of ``t`` tokens over the
    grid's batch axes: the loss's per-expert mean probability and
    assignment share are the global batch's, summed over them (the
    probabilities' sum with the gradient passed on as is, the counts
    without one)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t = xf.shape[0] if t is None else t
    logits = xf.to(torch.float32) @ L.use(p, "router", torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the k largest, ties toward the lower index — a stable
    # descending sort gives the same order
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # assignments per expert: float32 ones added by index, exact below 2^24
    # and on every device, the meta device included (where bincount is not)
    flat = expert_ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=xf.device))
    if grid is None:
        me = probs.mean(dim=0)
    else:
        me = shd.reduce_from(probs.sum(dim=0), grid, grid.row_axis) / t
        with torch.no_grad():
            counts = grid.all_reduce(counts, axis=grid.row_axis)
    aux = e * torch.sum(me * (counts / (t * k)))
    return gate_vals, expert_ids, aux


def _dispatch_local(xf, ids, cap: int, e: int, k: int, experts=None):
    """(T, D) tokens and (T, k) expert ids → the (E, C, D) buffer and the
    combine metadata (each assignment's rank in its expert's run, and
    whether it is kept).  ``experts`` = (lo, hi) builds the buffer's rows
    of those experts only (a rank's slice); the metadata covers every
    assignment."""
    t = xf.shape[0]
    lo, hi = (0, e) if experts is None else experts
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e + 1, device=xf.device, dtype=flat.dtype))
    slot = group_start[lo:hi, None] + torch.arange(cap, device=xf.device)
    valid = slot < group_start[lo + 1:hi + 1, None]
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


def _expert_compute(p, xe, cfg, partial=None):
    """The experts' batched products; ``partial`` as ``layers.use``."""
    dt = xe.dtype
    h = torch.bmm(xe, L.use(p, "wi", dt, partial=partial))
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.bmm(xe, L.use(p, "wg", dt, partial=partial))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, L.use(p, "wo", dt, partial=partial))


def moe_ffn(p, x, cfg, *, return_aux: bool = False, stats=None):
    """x (B, S, D) → (B, S, D) [, the aux-loss scalar].  ``stats``, a dict
    if given, receives the assignments made and those dropped for want of
    capacity (as 0-d tensors; the global batch's under a RankGrid).

    Under an ``activation_sharding`` context over a ``RankGrid``, ``x`` is
    the rank's rows of the context's ``batch`` and ``p`` the rank's
    parameters (:func:`_moe_ranks`)."""
    bsz, s, d = x.shape
    xf = x.reshape(bsz * s, d)
    ctx = shd.active_context()
    grid = None if ctx is None else shd.grid_of(ctx[0])
    if grid is not None:
        out, aux = _moe_ranks(p, xf, bsz, cfg, grid, stats)
    else:
        if p["wi"].shape[0] != cfg.num_experts:
            raise ValueError(
                "these experts are a rank's block of a RankGrid: run the "
                "model under activation_sharding(grid, rules, batch=...)")
        gate_vals, expert_ids, aux = _route(p, xf, cfg)
        out = _moe_local(p, xf, gate_vals, expert_ids, cfg,
                         capacity_for(xf.shape[0], cfg), stats)
    out = out.reshape(bsz, s, d)
    if cfg.shared_expert:
        out = out + L.ffn(p["shared"], x, cfg.activation)
    if return_aux:
        return out, aux
    return out


def _count(stats, kept, grid=None) -> None:
    """Adds the assignments made and dropped to ``stats``, summed over the
    data axes of ``grid`` when given (the ranks dispatched disjoint
    tokens)."""
    if stats is None:
        return
    dropped = (~kept).sum()
    made = kept.numel()
    if grid is not None:
        dropped = grid.all_reduce(dropped, axis="data")
        made *= grid.dp
    stats["assignments"] = stats.get("assignments", 0) + made
    stats["dropped"] = stats.get("dropped", 0) + dropped


def _moe_local(p, xf, gates, ids, cfg, cap: int, stats):
    """The one-process path on ``xf``: dispatch to every expert of ``p``,
    compute, combine."""
    e, k = cfg.num_experts, cfg.experts_per_token
    xe, rank, kept = _dispatch_local(xf, ids, cap, e, k)
    _count(stats, kept)
    ye = _expert_compute(p, xe, cfg)
    return _combine_local(ye, ids, gates, rank, kept, xf.shape[1])


def _moe_ranks(p, xf, bsz: int, cfg, grid, stats):
    """The MoE over a RankGrid, laid out as the JAX package's ``moe_ffn``
    lays it out over a (data, model) mesh → ``(out (T_loc, D), aux)``.

    t is the global token count and dp, mp the grid's data and model
    sizes.  The experts are on the model axis when mp divides E (the
    model holds them so: ``RankGrid.param_spec``), and then:

    * rows split over data (the rank holds its shard of the batch): the
      rank's tokens are its data shard, capacity ``capacity_for(t/dp)``;
    * rows held whole, dp divides t (dp > 1): the rank takes its block of
      the tokens (``take_block``: the gradient comes back whole) and the
      experts' gradient, a part on each data rank, is reduce-scattered by
      their FSDP gather (``partial``), so every leaf's gradient is whole,
      as for replicated rows; the blocks' outputs are gathered over data;
    * rows held whole otherwise: every token, capacity ``capacity_for(t)``
      (JAX's local path, its experts summed over the row).

    Each runs :func:`_expert_layout`.  With E not divisible by mp the
    experts replicate and the local path runs over every token (capacity
    ``capacity_for(t)``): rows split over data are gathered first and
    the rank keeps its own rows of the output."""
    e = cfg.num_experts
    rows = shd.active_batch()
    if rows is None:
        raise ValueError("a RankGrid's activation_sharding needs batch= "
                         "(the rows of the global batch)")
    split = grid.rows_split(rows)
    want = rows // grid.row_size if split else rows
    if bsz != want:
        raise ValueError(f"{bsz} rows on rank {grid.rank}, expected {want} "
                         f"of a {rows}-row batch on {grid.shape}")
    t = xf.shape[0] * grid.row_size if split else xf.shape[0]
    gates, ids, aux = _route(p, xf, cfg, grid if split else None, t)
    if split and grid.row_axis != "data" and grid.mp > 1:
        # "fsdp": the row's tokens, the data shard's
        own = xf.shape[0]
        xf, gates, ids = (shd.gather_blocks(a, grid, "model")
                          for a in (xf, gates, ids))
        out = _moe_data_shards(p, xf, gates, ids, cfg, grid, True, stats)
        assert out.shape[0] == own * grid.mp
        return shd.take_block(out, grid, "model"), aux
    return _moe_data_shards(p, xf, gates, ids, cfg, grid, split, stats), aux


def _moe_data_shards(p, xf, gates, ids, cfg, grid, split, stats):
    """:func:`_moe_ranks` once the rank holds its data shard's tokens
    (``split``) or every token → its output rows."""
    e = cfg.num_experts
    t_loc = xf.shape[0]
    t = t_loc * grid.dp if split else t_loc
    layout = e % grid.mp == 0
    want_e = e // grid.mp if layout else e
    if p["wi"].shape[0] != want_e:
        raise ValueError(f"{p['wi'].shape[0]} experts held, expected "
                         f"{want_e} on {grid.shape}")
    if not layout:
        if not split:
            return _moe_local(p, xf, gates, ids, cfg, capacity_for(t, cfg),
                              stats)
        lo = grid.data_index * t_loc
        out = _moe_local(p, shd.gather_blocks(xf, grid), shd.gather_blocks(
            gates, grid), shd.gather_blocks(ids, grid), cfg,
            capacity_for(t, cfg), stats)
        return out[lo:lo + t_loc]
    if split:
        return _expert_layout(p, xf, gates, ids, cfg, grid,
                              capacity_for(t_loc, cfg), stats, True)
    if grid.dp > 1 and t % grid.dp == 0:
        per = t // grid.dp
        lo = grid.data_index * per
        # each data rank computes the experts on its block of the tokens:
        # their gradients are parts, reduce-scattered over data
        pp = {name: L.use(p, name, xf.dtype, partial=True)
              for name in ("wi", "wg", "wo") if name in p}
        out = _expert_layout(pp, shd.take_block(xf, grid),
                             shd.take_block(gates, grid), ids[lo:lo + per],
                             cfg, grid, capacity_for(per, cfg), stats, True)
        return shd.gather_blocks(out, grid)
    return _expert_layout(p, xf, gates, ids, cfg, grid, capacity_for(t, cfg),
                          stats, False)


def _expert_layout(p, xf, gates, ids, cfg, grid, cap: int, stats,
                   disjoint: bool):
    """``_moe_shardmap``'s block on one rank: ``_dispatch_local`` of its
    tokens for its experts [r·e_loc, (r+1)·e_loc) only, ``_expert_compute``
    on its weights, the combine of the assignments it owns
    (``flat // e_loc == r``), summed over the model axis.  ``disjoint``:
    the data ranks dispatched disjoint tokens (``stats`` are summed over
    data)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    r = grid.model_index
    e_loc = e // grid.mp
    xf = shd.copy_to_model(xf, grid)
    gates = shd.copy_to_model(gates, grid)
    xe, rank, kept = _dispatch_local(xf, ids, cap, e, k,
                                     (r * e_loc, (r + 1) * e_loc))
    _count(stats, kept, grid if disjoint else None)
    ye = _expert_compute(p, xe, cfg)
    flat = ids.reshape(-1)
    mine = (flat // e_loc) == r
    yk = ye[torch.clamp(flat - r * e_loc, 0, e_loc - 1),
            torch.clamp(rank, 0, cap - 1)]
    yk = yk * (mine & kept)[:, None].to(yk.dtype)
    tl, d = xf.shape
    out = torch.sum(yk.reshape(tl, k, d)
                    * gates.reshape(tl, k, 1).to(yk.dtype), dim=1)
    return shd.reduce_from_model(out, grid)


def moe_dispatch_specs(cfg, mesh, rules):
    """The (E, C, D) buffer's logical axes — expert dim on the model axis,
    capacity on the data axis (for inspection)."""
    return (shd.EXPERT, shd.CAPACITY, None)
