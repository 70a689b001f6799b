"""GQA attention: prefill and training through the flash-attention kernel,
one-token decode against a KV cache, as in the JAX package's
``models/attention.py``.

Self-attention at equal lengths — causal, and the encoder's full one —
runs through ``kernels/flash_attention.py``'s wrapper (the bf16 wgmma
kernel, or the 3xTF32 one in float32; on CPU tensors their plain version),
with q, k, v transposed once per call from the model's (B, S, H, D) into
the kernel's contiguous (B, H, S, D).  The kernel takes any S and gives
the same numbers for any S, so neither the JAX package's chunking over
queries (``q_chunk_for``) nor the Pallas kernel's block check (which
``kernels.ops.flash_attention`` keeps) applies here.  Decode and
cross-attention (Sq ≠ Sk) are plain PyTorch, as no kernel computes them.

On a grid of ranks a rank projects its q heads (HEADS on ``model``) and
its KV heads (KV_HEADS on ``model`` where ``model`` divides them, else
every KV head, sliced to those its q heads read before the kernel:
:func:`kv_for_q`), and ``wo`` is row-parallel.  A KV cache is laid out as
``transformer.kv_cache_axes`` says: by KV heads, or by sequence
(KV_SEQ, where the KV heads do not divide the production model axis of
16) — there a prefill writes the rank's block of positions of every KV
head and a decode step is flash-decoding (:func:`decode_attention`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref
from repro_torch.models import layers as L

NEG_INF = -1e30


def attention_leaves(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    scale = 1.0 / np.sqrt(d)
    leaves = {
        "wq": L.normal((d, h, hd), (shd.FSDP, shd.HEADS, None), scale),
        "wk": L.normal((d, hkv, hd), (shd.FSDP, shd.KV_HEADS, None), scale),
        "wv": L.normal((d, hkv, hd), (shd.FSDP, shd.KV_HEADS, None), scale),
        "wo": L.normal((h, hd, d), (shd.HEADS, None, shd.FSDP),
                       1.0 / np.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        leaves["bq"] = L.Leaf((h, hd), (shd.HEADS, None), ("zeros",))
        leaves["bk"] = L.Leaf((hkv, hd), (shd.KV_HEADS, None), ("zeros",))
        leaves["bv"] = L.Leaf((hkv, hd), (shd.KV_HEADS, None), ("zeros",))
    return leaves


def kv_project(p, x, *, tp=None):
    """x (B, S, D) → the rank's k, v (B, S, Hkv_loc, hd): its block of KV
    heads, or every one where they replicate (summed over ``model`` in
    the backward when the q heads are split, ``tp``: each rank then reads
    a part of them)."""
    dt = x.dtype
    out = []
    for w, b in (("wk", "bk"), ("wv", "bv")):
        wk = L.use(p, w, dt)
        kv_tp = L.tp_split(p, w, wk, 1)
        if tp is not None and kv_tp is None:
            wk = shd.copy_to(wk, tp)
        t = L.matmul_in(x, wk)
        if b in p:
            bk = L.use(p, b, dt)
            if tp is not None and kv_tp is None:
                bk = shd.copy_to(bk, tp)
            t = t + bk
        out.append(t)
    return out


def qkv_project(p, x, positions, cfg, *, rope: bool = True):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Hkv, hd); on a grid the
    rank's q heads and its k/v as :func:`kv_project` gives them."""
    dt = x.dtype
    wq = L.use(p, "wq", dt)
    tp = L.tp_split(p, "wq", wq, 1)
    x = shd.copy_to(x, tp)
    q = L.matmul_in(x, wq)
    if "bq" in p:
        q = q + L.use(p, "bq", dt)
    k, v = kv_project(p, x, tp=tp)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def q_heads(q, cfg):
    """The first q head of ``q`` (…, H_loc, hd) among the config's H: the
    rank's block on the active grid where ``model`` splits them."""
    grid = shd.active_grid()
    h_loc = q.shape[-2]
    if grid is None or h_loc == cfg.num_heads:
        return 0
    return grid.model_index * h_loc


def kv_range(lo: int, h_loc: int, cfg) -> tuple:
    """The KV heads q heads [lo, lo + h_loc) read (GQA groups of
    H / Hkv)."""
    group = cfg.num_heads // cfg.num_kv_heads
    if h_loc % group and group % h_loc:
        raise ValueError(f"{h_loc} q heads a rank cannot be laid over GQA "
                         f"groups of {group}")
    return lo // group, (lo + h_loc - 1) // group + 1


def kv_for_q(q, k, v, cfg):
    """k, v (…, Hkv_loc, hd) cut to the KV heads the rank's q heads read:
    as they are where they are the rank's block (KV_HEADS on ``model``) or
    the q heads are whole."""
    hkv = cfg.num_kv_heads
    if k.shape[-2] != hkv or q.shape[-2] == cfg.num_heads:
        return k, v
    lo, hi = kv_range(q_heads(q, cfg), q.shape[-2], cfg)
    return k[..., lo:hi, :], v[..., lo:hi, :]


def out_project(p, o):
    """o (B, S, H, hd) -> (B, S, D); row-parallel on a grid where the
    heads are a block on ``model``."""
    wo = L.use(p, "wo", o.dtype)
    out = o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
    return shd.reduce_from(out, L.tp_split(p, "wo", wo, 0))


def attend(q, k, v, *, causal: bool, kernel: str):
    """Heads-first attention through the flash-attention kernel
    (``kernel="cuda"``: ``kernels/flash_attention.py``, which takes any S)
    or its oracle (``"reference"``).  q (B, H, S, hd); k, v (B, Hkv, S,
    hd), contiguous."""
    if kernel == "reference":
        return ref.flash_attention(q, k, v, causal=causal)
    if kernel != "cuda":
        raise ValueError(f"kernel must be 'cuda' or 'reference', got "
                         f"{kernel!r}")
    return kfa.flash_attention(q, k, v, causal=causal)


def self_attention(q, k, v, *, causal: bool = True, kernel: str = "cuda"):
    """Self-attention at equal lengths, causal or full. q (B, S, H, hd);
    k, v (B, S, Hkv, hd) → (B, S, H, hd), through :func:`attend`."""
    def heads_first(t):
        return t.transpose(1, 2).contiguous()

    o = attend(heads_first(q), heads_first(k), heads_first(v),
               causal=causal, kernel=kernel)
    return o.transpose(1, 2)


def _expand_kv(k, group):
    if group == 1:
        return k
    return k.repeat_interleave(group, dim=2)


def full_attention(q, k, v, *, k_mask=None):
    """Bidirectional attention (encoder / cross-attention), plain.

    q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd); k_mask optional (B, Sk) bool.
    """
    hd = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    kf = _expand_kv(k, group).to(torch.float32)
    qf = q.to(torch.float32) / np.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if k_mask is not None:
        logits = torch.where(k_mask[:, None, None, :], logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, _expand_kv(v, group))


def decode_attention(q, k_cache, v_cache, length, *, grid=None,
                     seq_lo: int = 0):
    """One-step decode: q (B, 1, H, hd) over the cache (B, S, Hkv, hd);
    positions >= ``length`` are masked.  Grouped GQA: the cache is never
    expanded to H heads.  The logits are float32 (the JAX package's
    ``q / sqrt(hd)`` promotes to float32), the probabilities in q's dtype.

    With ``grid`` the cache is the rank's block of positions from
    ``seq_lo`` (flash-decoding): the softmax's max is a MAX over
    ``model``, its sum and the output SUMs."""
    b, s, hkv, hd = k_cache.shape
    h = q.shape[2]
    group = h // hkv
    qg = q.reshape(b, 1, hkv, group, hd).to(torch.float32) / np.sqrt(hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k_cache.to(torch.float32))
    mask = torch.arange(seq_lo, seq_lo + s, device=q.device) < length
    logits = logits.masked_fill(~mask, NEG_INF)
    if grid is None:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    else:
        m = grid.all_reduce(logits.amax(dim=-1, keepdim=True), "max",
                            axis="model")
        e = torch.exp(logits - m)
        total = grid.all_reduce(e.sum(dim=-1, keepdim=True), axis="model")
        probs = (e / total).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    if grid is not None:
        out = grid.all_reduce(out.contiguous(), axis="model")
    return out.reshape(b, 1, h, hd)


def cache_layout(cfg, k_cache, cache_len: int) -> str:
    """How the active grid holds a KV cache of ``cache_len`` positions
    whose rank block is ``k_cache`` (B, S_loc, Hkv_loc, hd): ``"local"``
    (no grid), ``"heads"`` (its block of KV heads), ``"seq"`` (its block of
    positions, every head) or ``"whole"``."""
    if shd.active_grid() is None:
        return "local"
    if k_cache.shape[-2] != cfg.num_kv_heads:
        return "heads"
    return "seq" if k_cache.shape[-3] != cache_len else "whole"


def kv_all_heads(k, cfg):
    """k (…, Hkv_loc, hd) with every KV head: the rank's block gathered
    over ``model``."""
    if k.shape[-2] == cfg.num_kv_heads:
        return k
    return shd.gather(k, shd.active_grid(), "model", -2)


def write_cache(k_cache, v_cache, k, v, pos: int, cfg, cache_len: int):
    """Writes the rank's k, v (B, S_new, Hkv_loc, hd) at positions [pos,
    pos + S_new) into its block of the cache, in place: its KV heads
    (``"heads"``), or its positions of every KV head (``"seq"``; the rank
    that owns none of them writes nothing)."""
    layout = cache_layout(cfg, k_cache, cache_len)
    if layout in ("local", "heads"):
        return update_cache(k_cache, v_cache, k, v, pos)
    k, v = kv_all_heads(k, cfg), kv_all_heads(v, cfg)
    if layout == "whole":
        return update_cache(k_cache, v_cache, k, v, pos)
    n = k_cache.shape[1]
    lo = shd.active_grid().model_index * n
    a, b = max(pos, lo), min(pos + k.shape[1], lo + n)
    if a < b:
        update_cache(k_cache, v_cache, k[:, a - pos:b - pos],
                     v[:, a - pos:b - pos], a - lo)
    return k_cache, v_cache


def cached_attention(q, k_cache, v_cache, length: int, cfg,
                     cache_len: int):
    """:func:`decode_attention` of the rank's q heads (B, 1, H_loc, hd)
    over its block of a cache of ``cache_len`` positions: over its KV
    heads, over every position (cut to the KV heads its q heads read), or
    flash-decoding over its positions with every q head (gathered over
    ``model``; its own heads of the output kept)."""
    layout = cache_layout(cfg, k_cache, cache_len)
    if layout in ("local", "heads"):
        return decode_attention(q, k_cache, v_cache, length)
    if layout == "whole":
        k, v = kv_for_q(q, k_cache, v_cache, cfg)
        return decode_attention(q, k, v, length)
    grid = shd.active_grid()
    h_loc = q.shape[2]
    lo = q_heads(q, cfg)
    q_all = q if h_loc == cfg.num_heads else shd.gather(q, grid, "model", 2)
    o = decode_attention(q_all, k_cache, v_cache, length, grid=grid,
                         seq_lo=grid.model_index * k_cache.shape[1])
    return o[:, :, lo:lo + h_loc]


def update_cache(k_cache, v_cache, k_new, v_new, pos: int):
    """Writes (B, S_new, Hkv, hd) into the cache at offset ``pos``, in
    place (the JAX package's ``launch/serve.py`` donates the cache to the
    step, which is the same contract), and returns the caches."""
    s = k_new.shape[1]
    k_cache[:, pos:pos + s] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
