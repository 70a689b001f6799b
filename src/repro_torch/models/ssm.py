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


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv: xbc (B, S, C), conv_w (K, C)."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = sum(pad[:, i:i + s, :] * conv_w[i][None, None, :] for i in range(k))
    return F.silu(out)


def _gated_norm(x, z, scale, eps):
    xf = (x * F.silu(z)).to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
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


def _ssd(p, hidden, cfg, kernel: str, final_state: bool):
    """The block up to the gated norm's input: ``(y, z, tail, state)``."""
    bsz, s, _ = hidden.shape
    di, n, g, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                        cfg.ssm_heads, cfg.ssm_head_dim)
    zxbcdt = L.matmul_in(hidden, L.cast(p["in_proj"], hidden.dtype))
    zxbcdt = shd.constrain(zxbcdt, (shd.BATCH, None, shd.TENSOR))
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([x, b, c], dim=-1)
    tail = xbc_raw[:, s - (cfg.ssm_conv - 1):, :] if final_state else None
    xbc = _causal_conv(xbc_raw, L.cast(p["conv_w"], hidden.dtype))
    x, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))  # (H,)
    xh = x.reshape(bsz, s, nh, hd)
    bm = b.reshape(bsz, s, g, n)
    cm = c.reshape(bsz, s, g, n)
    out = ops.ssd_scan(xh, dt, a, bm, cm, chunk=chunk_for(cfg, s),
                       impl=kernel, return_final_state=final_state)
    y, state = out if final_state else (out, None)
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(bsz, s, di).to(hidden.dtype)
    return y, z, tail, state


def ssm_forward(p, hidden, cfg, *, kernel: str = "cuda"):
    """Training/prefill SSD pass. hidden (B, S, D) -> (B, S, D)."""
    y, z, _, _ = _ssd(p, hidden, cfg, kernel, final_state=False)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    return L.matmul_in(y, L.cast(p["out_proj"], y.dtype))


def ssm_prefill(p, hidden, cfg, *, kernel: str = "cuda"):
    """Like ``ssm_forward`` but also returns the decode cache: the SSM
    state after the last position (from the kernel path) and the conv tail
    (the raw projections' last d_conv − 1 rows)."""
    y, z, tail, state = _ssd(p, hidden, cfg, kernel, final_state=True)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    out = L.matmul_in(y, L.cast(p["out_proj"], y.dtype))
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
    """One-token decode. hidden (B, 1, D); cache from init_ssm_cache.
    Returns ``(out (B, 1, D), new cache)``."""
    bsz = hidden.shape[0]
    di, n, g, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                        cfg.ssm_heads, cfg.ssm_head_dim)
    zxbcdt = L.matmul_in(hidden, L.cast(p["in_proj"], hidden.dtype))[:, 0]
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, b, c], dim=-1)  # (B, C)
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv_w = L.cast(p["conv_w"], hidden.dtype)
    out = torch.einsum("bkc,kc->bc", window, conv_w)
    xbc = F.silu(out)
    new_conv = window[:, 1:, :]
    x, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    decay = torch.exp(a[None] * dt)  # (B, H)
    xh = x.reshape(bsz, nh, hd).to(torch.float32)
    rep = nh // g
    bm = b.reshape(bsz, g, n).repeat_interleave(rep, dim=1).to(torch.float32)
    cm = c.reshape(bsz, g, n).repeat_interleave(rep, dim=1).to(torch.float32)
    state = cache["ssm"] * decay[..., None, None] + (
        (dt[..., None] * bm)[..., :, None] * xh[..., None, :])  # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", cm, state)
    y = y + p["d_skip"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(hidden.dtype)
    y = _gated_norm(y, z[:, None, :], p["norm_scale"], cfg.norm_eps)
    out = L.matmul_in(y, L.cast(p["out_proj"], y.dtype))
    return out, {"ssm": state, "conv": new_conv}
