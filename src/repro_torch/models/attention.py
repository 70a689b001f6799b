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


def qkv_project(p, x, positions, cfg, *, rope: bool = True):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Hkv, hd)."""
    dt = x.dtype
    q = L.matmul_in(x, L.cast(p["wq"], dt))
    k = L.matmul_in(x, L.cast(p["wk"], dt))
    v = L.matmul_in(x, L.cast(p["wv"], dt))
    if "bq" in p:
        q = q + L.cast(p["bq"], dt)
        k = k + L.cast(p["bk"], dt)
        v = v + L.cast(p["bv"], dt)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(p, o):
    """o (B, S, H, hd) -> (B, S, D)."""
    wo = L.cast(p["wo"], o.dtype)
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


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


def decode_attention(q, k_cache, v_cache, length):
    """One-step decode: q (B, 1, H, hd) over the cache (B, S, Hkv, hd);
    positions >= ``length`` are masked.  Grouped GQA: the cache is never
    expanded to H heads.  The logits are float32 (the JAX package's
    ``q / sqrt(hd)`` promotes to float32), the probabilities in q's dtype."""
    b, s, hkv, hd = k_cache.shape
    h = q.shape[2]
    group = h // hkv
    qg = q.reshape(b, 1, hkv, group, hd).to(torch.float32) / np.sqrt(hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k_cache.to(torch.float32))
    mask = torch.arange(s, device=q.device) < length
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def update_cache(k_cache, v_cache, k_new, v_new, pos: int):
    """Writes (B, S_new, Hkv, hd) into the cache at offset ``pos``, in
    place (the JAX package's ``launch/serve.py`` donates the cache to the
    step, which is the same contract), and returns the caches."""
    s = k_new.shape[1]
    k_cache[:, pos:pos + s] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
