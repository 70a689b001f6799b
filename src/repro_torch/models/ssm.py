"""Mamba2 (SSD) block: the chunked prefill path through the SSD chunk
kernel, and the O(1)-state decode step, as in the JAX package's
``models/ssm.py``.

The prefill takes the chunked state-space-duality form through
``kernels.ops.ssd_scan`` (the within-chunk step is the CUDA kernel of
``csrc/ssd_scan.cu``, on CPU tensors its plain version; the cross-chunk
recurrence is plain PyTorch) where the JAX package calls
``kref.ssd_scan_chunked_ref``.  The causal conv, the gated norm and the
decode step are plain PyTorch.  Decode carries two states per layer: the
SSM state (B, H, N, P) and the causal-conv tail (B, d_conv-1, channels).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import layers as L


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssm_leaves(cfg) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    g, nh = cfg.ssm_groups, cfg.ssm_heads
    proj_out = 2 * di + 2 * g * n + nh  # [z, x, B, C, dt]
    return {
        "in_proj": L.normal((d, proj_out), (shd.FSDP, shd.TENSOR),
                            1 / np.sqrt(d)),
        "conv_w": L.normal((cfg.ssm_conv, conv_channels(cfg)),
                           (None, shd.TENSOR), 1 / np.sqrt(cfg.ssm_conv)),
        "a_log": L.Leaf((nh,), (None,), ("log_linspace", 1.0, 16.0),
                        keep_float32=True),
        "dt_bias": L.Leaf((nh,), (None,), ("zeros",), keep_float32=True),
        "d_skip": L.Leaf((nh,), (None,), ("ones",), keep_float32=True),
        "norm_scale": L.Leaf((di,), (shd.TENSOR,), ("ones",),
                             keep_float32=True),
        "out_proj": L.normal((di, d), (shd.TENSOR, shd.FSDP),
                             1 / np.sqrt(di)),
    }


def check_head_dim(cfg) -> None:
    """The SSD chunk kernel is compiled for P in ``ssd_scan.HEAD_DIMS``."""
    if cfg.ssm_head_dim not in kssd.HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: ssm_head_dim={cfg.ssm_head_dim}, but the SSD chunk "
            f"kernel (csrc/ssd_scan.cu) takes P in {kssd.HEAD_DIMS}")


def _split_proj(cfg, zxbcdt):
    di, n, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, g * n, g * n, nh], dim=-1)


def _heads(cfg):
    """``(grid, lo, hi)``: the rank's SSD heads [lo, hi) — its block where
    the active grid puts TENSOR on ``model`` and ``model`` divides the
    heads (d_inner's blocks are then head-aligned), with the grid — else
    every head and None.  Raises ``ValueError`` for heads split so with
    more than one SSM group (a rank's local head would map to its group
    by its local index)."""
    grid = shd.active_grid()
    nh = cfg.ssm_heads
    if grid is None or grid.mp == 1 or nh % grid.mp \
            or "model" not in shd._mesh_axes_for(grid.rules, shd.TENSOR):
        return None, 0, nh
    if cfg.ssm_groups > 1:
        raise ValueError(f"{cfg.name}: {cfg.ssm_groups} SSM groups cannot "
                         f"be laid over heads split on the model axis")
    per = nh // grid.mp
    return grid, grid.model_index * per, (grid.model_index + 1) * per


def _fit(p, name, w, dim, ranges, grid, partial):
    """Leaf ``name`` (``w`` as ``layers.use`` gives it) cut to ``ranges``
    of ``dim`` (``dist.sharding.fit_block``); as is off a grid."""
    grid = grid or shd.active_grid()
    if grid is None:
        return w
    return shd.fit_block(w, grid, dim, ranges, L.full_dim(p, name, dim),
                         partial=partial)


def _proj(p, hidden, cfg, tp):
    """The packed ``[z, x, B, C, dt]`` projection, whole on every rank.
    ``in_proj`` is (FSDP, TENSOR): a rank computes its contiguous column
    block and the blocks are gathered over ``model`` (JAX's HLO re-lays
    them with a collective-permute and an all-to-all); ``tp``: the grid
    when the ranks then read different heads of it."""
    w = L.use(p, "in_proj", hidden.dtype)
    col = L.tp_split(p, "in_proj", w, 1)
    grid = col or tp
    if grid is not None:
        hidden = shd.copy_to(hidden, grid)
        if col is None:
            w = shd.copy_to(w, grid)
    zxbcdt = L.matmul_in(hidden, w)
    if col is not None:
        zxbcdt = shd.gather(zxbcdt, col, "model", -1,
                            partial=tp is not None)
    return zxbcdt


def _conv_block(t, cfg):
    """The rank's block of the conv tail's channels, as the SSM cache
    holds it (TENSOR on ``model``, where it divides the channels)."""
    grid = shd.active_grid()
    ch = conv_channels(cfg)
    if grid is None:
        return t
    n = shd.rows_block_shape(t.shape, ssm_cache_axes(cfg)["conv"], grid)[-1]
    if n == ch:
        return t
    return t[..., grid.model_index * n:(grid.model_index + 1) * n]


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv: xbc (B, S, C), conv_w (K, C)."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = sum(pad[:, i:i + s, :] * conv_w[i][None, None, :] for i in range(k))
    return F.silu(out)


def _gated_norm(x, z, scale, eps, tp=None, width=None):
    """RMS norm of x·silu(z) over d_inner: with ``tp`` the rank holds a
    block of ``width`` channels, so its sum of squares is summed over
    ``model`` — and so is its gradient, since each rank's output reads the
    sum."""
    xf = (x * F.silu(z)).to(torch.float32)
    if tp is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = shd.copy_to(shd.reduce_from(
            (xf * xf).sum(dim=-1, keepdim=True), tp), tp) / width
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def chunk_for(cfg, s: int) -> int:
    """``min(ssm_chunk, s)``, halved until it divides ``s``."""
    chunk = min(cfg.ssm_chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def _head_params(p, cfg, tp, lo, hi):
    """a (the decay rates), dt_bias and d_skip of heads [lo, hi), float32;
    summed over ``model`` in the backward where the ranks read different
    heads."""
    out = []
    for name in ("a_log", "dt_bias", "d_skip"):
        w = L.use(p, name, torch.float32)
        out.append(_fit(p, name, w, 0, [(lo, hi)], tp, tp is not None))
    a_log, dt_bias, d_skip = out
    return -torch.exp(a_log), dt_bias, d_skip


def _out(p, y, z, cfg, tp, lo, hi):
    """The gated norm and ``out_proj`` ((TENSOR, FSDP): row-parallel over
    the heads' channels) of the rank's heads."""
    hd = cfg.ssm_head_dim
    rng = [(lo * hd, hi * hd)]
    scale = _fit(p, "norm_scale", L.use(p, "norm_scale"), 0, rng, tp,
                 tp is not None)
    y = _gated_norm(y, z, scale, cfg.norm_eps, tp, cfg.d_inner)
    w = _fit(p, "out_proj", L.use(p, "out_proj", y.dtype), 0, rng, tp,
             tp is not None)
    return shd.reduce_from(L.matmul_in(y, w), tp)


def _ssd(p, hidden, cfg, kernel: str, final_state: bool):
    """The block up to the gated norm's input: ``(y, z, tail, state, tp,
    lo, hi)`` — on a grid, of the rank's heads [lo, hi) (:func:`_heads`;
    ``tp`` the grid when they are a block), the conv tail its block of the
    cache's channels."""
    bsz, s, _ = hidden.shape
    di, n, g, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                        cfg.ssm_heads, cfg.ssm_head_dim)
    tp, lo, hi = _heads(cfg)
    zxbcdt = _proj(p, hidden, cfg, tp)
    zxbcdt = shd.constrain(zxbcdt, (shd.BATCH, None, shd.TENSOR))
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    tail = None
    if final_state:
        tail = _conv_block(torch.cat([x, b, c], dim=-1)[
            :, s - (cfg.ssm_conv - 1):, :], cfg)
    conv_w = L.use(p, "conv_w", hidden.dtype)
    if tp is not None:
        z, x = z[..., lo * hd:hi * hd], x[..., lo * hd:hi * hd]
        dt = dt[..., lo:hi]
    conv_w = _fit(p, "conv_w", conv_w, 1,
                  [(lo * hd, hi * hd), (di, di + 2 * g * n)], tp,
                  tp is not None)
    xbc = _causal_conv(torch.cat([x, b, c], dim=-1), conv_w)
    dl = (hi - lo) * hd
    x, b, c = torch.split(xbc, [dl, g * n, g * n], dim=-1)

    a, dt_bias, d_skip = _head_params(p, cfg, tp, lo, hi)
    dt = _softplus(dt.to(torch.float32) + dt_bias)
    xh = x.reshape(bsz, s, hi - lo, hd)
    bm = b.reshape(bsz, s, g, n)
    cm = c.reshape(bsz, s, g, n)
    out = ops.ssd_scan(xh, dt, a, bm, cm, chunk=chunk_for(cfg, s),
                       impl=kernel, return_final_state=final_state)
    y, state = out if final_state else (out, None)
    y = y + d_skip[None, None, :, None] * xh
    y = y.reshape(bsz, s, dl).to(hidden.dtype)
    return y, z, tail, state, tp, lo, hi


def ssm_forward(p, hidden, cfg, *, kernel: str = "cuda"):
    """Training/prefill SSD pass. hidden (B, S, D) -> (B, S, D)."""
    y, z, _, _, tp, lo, hi = _ssd(p, hidden, cfg, kernel, final_state=False)
    return _out(p, y, z, cfg, tp, lo, hi)


def ssm_prefill(p, hidden, cfg, *, kernel: str = "cuda"):
    """Like ``ssm_forward`` but also returns the decode cache: the SSM
    state after the last position (from the kernel path) and the conv tail
    (the raw projections' last d_conv − 1 rows)."""
    y, z, tail, state, tp, lo, hi = _ssd(p, hidden, cfg, kernel,
                                         final_state=True)
    out = _out(p, y, z, cfg, tp, lo, hi)
    return out, {"ssm": state, "conv": tail.to(hidden.dtype)}


def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    """Per-layer decode state (the caller stacks over layers)."""
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                            dtype=dtype, device=device),
    }


def ssm_cache_axes(cfg) -> dict:
    return {"ssm": (shd.BATCH, shd.HEADS, None, None),
            "conv": (shd.BATCH, None, shd.TENSOR)}


def ssm_decode_step(p, hidden, cache, cfg):
    """One-token decode. hidden (B, 1, D); cache from init_ssm_cache (on a
    grid, the rank's blocks: its heads' state, its block of the conv
    tail's channels).  Returns ``(out (B, 1, D), new cache)``."""
    bsz = hidden.shape[0]
    di, n, g, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                        cfg.ssm_heads, cfg.ssm_head_dim)
    tp, lo, hi = _heads(cfg)
    zxbcdt = _proj(p, hidden, cfg, tp)[:, 0]
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, b, c], dim=-1)  # (B, C)
    conv = cache["conv"]
    grid = shd.active_grid()
    if grid is not None and conv.shape[-1] != conv_channels(cfg):
        conv = shd.gather(conv, grid, "model", -1)
    window = torch.cat([conv, xbc[:, None, :]], dim=1)
    new_conv = _conv_block(window[:, 1:, :], cfg)
    if tp is not None:
        z, dt = z[..., lo * hd:hi * hd], dt[..., lo:hi]
        window = torch.cat([window[..., lo * hd:hi * hd],
                            window[..., di:]], dim=-1)
    conv_w = _fit(p, "conv_w", L.use(p, "conv_w", hidden.dtype), 1,
                  [(lo * hd, hi * hd), (di, di + 2 * g * n)], tp,
                  tp is not None)
    out = torch.einsum("bkc,kc->bc", window, conv_w)
    xbc = F.silu(out)
    dl = (hi - lo) * hd
    x, b, c = torch.split(xbc, [dl, g * n, g * n], dim=-1)

    a, dt_bias, d_skip = _head_params(p, cfg, tp, lo, hi)
    dt = _softplus(dt.to(torch.float32) + dt_bias)
    decay = torch.exp(a[None] * dt)  # (B, H)
    h_loc = hi - lo
    xh = x.reshape(bsz, h_loc, hd).to(torch.float32)
    rep = nh // g
    bm = b.reshape(bsz, g, n).repeat_interleave(
        h_loc if g == 1 else rep, dim=1).to(torch.float32)
    cm = c.reshape(bsz, g, n).repeat_interleave(
        h_loc if g == 1 else rep, dim=1).to(torch.float32)
    state = cache["ssm"] * decay[..., None, None] + (
        (dt[..., None] * bm)[..., :, None] * xh[..., None, :])  # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", cm, state)
    y = y + d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, dl).to(hidden.dtype)
    return _out(p, y, z[:, None, :], cfg, tp, lo, hi), {"ssm": state,
                                                        "conv": new_conv}
