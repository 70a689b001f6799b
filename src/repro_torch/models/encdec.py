"""Encoder-decoder stack (the Whisper family), as in the JAX package's
``models/encdec.py``.

The audio conv frontend is a stub there and here: ``batch["frames"]``
holds precomputed frame embeddings (B, S_enc, D).  The encoder adds
learned absolute positions (``enc_pos``) and runs full self-attention; the
decoder runs causal self-attention with RoPE, cross-attention on the
encoder's output (no RoPE) and a GELU MLP; the embedding table is tied.
Both self-attentions run at equal lengths through the flash-attention
kernel (``attention.self_attention``: ``causal=False`` for the encoder);
cross-attention (Sq ≠ Sk) and decode are plain PyTorch, as no kernel
computes them.  On a grid of ranks the layers take the dense layout
(``models/layers.py``, ``models/attention.py``): ``enc_pos`` is (None,
FSDP), cross-attention reads the rank's heads, and the cross-attention
cache is laid out as the self-attention one.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig


class DecoderLayer(L.ParamNode):
    """Self-attention, cross-attention and the FFN, each after an
    RMSNorm (``ln1``, ``lnx``, ``ln2``)."""

    def __init__(self, cfg: ModelConfig, *, device, mesh=None):
        kw = dict(cfg=cfg, device=device, mesh=mesh)
        super().__init__(children={
            "ln1": T._node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "attn": T._node(A.attention_leaves(cfg), **kw),
            "ln2": T._node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "ffn": T._node(L.ffn_leaves(cfg.d_model, cfg.d_ff,
                                        cfg.activation), **kw),
            "xattn": T._node(A.attention_leaves(cfg), **kw),
            "lnx": T._node(L.rmsnorm_leaves(cfg.d_model), **kw),
        })


def build(cfg: ModelConfig, *, device, mesh=None) -> dict:
    """The root's children, in the JAX package's key order."""
    kw = dict(cfg=cfg, device=device, mesh=mesh)
    return {
        "embed": T._node(L.embed_leaves(cfg.padded_vocab, cfg.d_model), **kw),
        "enc_pos": T._node({"table": L.normal(
            (cfg.encoder_seq, cfg.d_model), (None, shd.FSDP), 0.02)}, **kw),
        "encoder": T.Stack([T.DenseLayer(**kw)
                            for _ in range(cfg.num_encoder_layers)]),
        "decoder": T.Stack([DecoderLayer(**kw)
                            for _ in range(cfg.num_layers)]),
        "enc_norm": T._node(L.rmsnorm_leaves(cfg.d_model), **kw),
        "final_norm": T._node(L.rmsnorm_leaves(cfg.d_model), **kw),
    }


def encode(params, frames, cfg: ModelConfig, *, kernel: str):
    """frames (B, S_enc, D), the stub frontend's embeddings."""
    b, s, _ = frames.shape
    dt = cfg.tdtype
    h = frames.to(dt) + L.use(params["enc_pos"], "table", dt)[:s]
    positions = T._positions(b, s, frames.device)
    body = T.maybe_remat(lambda hh, lp: T.dense_layer_fwd(
        lp, hh, positions, cfg, kernel=kernel, causal=False)[0], cfg)
    for lp in params["encoder"]:
        h = body(h, lp)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def _cross_q(p, h, cfg):
    """The cross-attention's input norm and the rank's q heads."""
    x = L.rmsnorm(p["lnx"], h, cfg.norm_eps)
    wq = L.use(p["xattn"], "wq", x.dtype)
    tp = L.tp_split(p["xattn"], "wq", wq, 1)
    return L.matmul_in(shd.copy_to(x, tp), wq), tp


def _cross_kv(p, enc_out, tp=None):
    """The encoder's keys/values: the rank's KV heads (``tp``: the grid
    when the q heads are split, so the encoder's output enters through
    ``copy_to``)."""
    return A.kv_project(p, shd.copy_to(enc_out, tp), tp=tp)


def _cross(p, h, enc_out, cfg):
    """Cross-attention on the encoder's output, plain."""
    q, tp = _cross_q(p, h, cfg)
    xk, xv = _cross_kv(p["xattn"], enc_out, tp)
    o = A.full_attention(q, *A.kv_for_q(q, xk, xv, cfg))
    return h + A.out_project(p["xattn"], o), (xk, xv)


def _decoder_layer(p, h, enc_out, positions, cfg, *, kernel: str):
    """Returns ``(h, (k, v, xk, xv))``."""
    x = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    q, k, v = A.qkv_project(p["attn"], x, positions, cfg)
    o = A.self_attention(q, *A.kv_for_q(q, k, v, cfg), causal=True,
                         kernel=kernel)
    h = h + A.out_project(p["attn"], o)
    h, (xk, xv) = _cross(p, h, enc_out, cfg)
    x = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    return h + L.ffn(p["ffn"], x, cfg.activation), (k, v, xk, xv)


def forward(params, tokens, frames, cfg: ModelConfig, *, kernel: str):
    """Returns ``(logits (B, S, V_padded), aux = 0)``."""
    enc_out = encode(params, frames, cfg, kernel=kernel)
    b, s = tokens.shape
    positions = T._positions(b, s, tokens.device)
    h = T.embed_tokens(params, tokens, cfg)
    body = T.maybe_remat(lambda hh, lp: _decoder_layer(
        lp, hh, enc_out, positions, cfg, kernel=kernel)[0], cfg)
    for lp in params["decoder"]:
        h = body(h, lp)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return T.lm_logits(params, h, cfg), aux


def train_loss(params, batch, cfg: ModelConfig, *, kernel: str,
               parts=None):
    logits, _ = forward(params, batch["tokens"], batch["frames"], cfg,
                        kernel=kernel)
    ce = T.loss_ce(logits, batch["labels"], cfg)
    share = shd.rows_share(batch["tokens"].shape[0])
    if share != 1.0:
        ce = ce * share
    if parts is not None:
        parts["ce"] = ce.detach()
        parts["aux"] = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               grid=None):
    """Self-attention keys/values (``k``, ``v``) and the encoder's
    cross-attention ones (``xk``, ``xv``), stacked over decoder layers —
    on ``grid``, the rank's rows and blocks, and ``"cache_len"``."""
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    dt = cfg.tdtype
    kv_axes = T.kv_cache_axes(cfg)
    self_shape = (cfg.num_layers, batch, cache_len, hkv, hd)
    cross_shape = (cfg.num_layers, batch, cfg.encoder_seq, hkv, hd)
    cache = {name: torch.zeros(shd.rows_block_shape(shape, kv_axes, grid),
                               dtype=dt, device=device)
             for name, shape in (("k", self_shape), ("v", self_shape),
                                 ("xk", cross_shape), ("xv", cross_shape))}
    axes = {name: kv_axes for name in cache}
    if grid is not None:
        cache["cache_len"] = cache_len
    return cache, axes


def prefill(params, tokens, frames, cfg: ModelConfig, *, kernel: str,
            cache_len: int | None = None):
    """Encodes the frames and processes the prompt; returns
    ``(last-position logits (B, 1, V), cache)``."""
    enc_out = encode(params, frames, cfg, kernel=kernel)
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len={cache_len} is shorter than the "
                         f"prompt ({s})")
    positions = T._positions(b, s, tokens.device)
    h = T.embed_tokens(params, tokens, cfg)
    grid = shd.active_grid()
    if grid is None:
        kv = {"k": [], "v": [], "xk": [], "xv": []}
        for lp in params["decoder"]:
            h, (k, v, xk, xv) = _decoder_layer(lp, h, enc_out, positions,
                                               cfg, kernel=kernel)
            for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
                kv[name].append(t)
        cache = {name: torch.stack(ts) for name, ts in kv.items()}
        for name in ("k", "v"):
            pad = torch.zeros((cfg.num_layers, b, cache_len, *k.shape[2:]),
                              dtype=k.dtype, device=k.device)
            pad[:, :, :s] = cache[name]
            cache[name] = pad
    else:  # the rank's blocks, written as the layers run
        cache, _ = init_cache(cfg, b, cache_len, tokens.device, grid)
        for i, lp in enumerate(params["decoder"]):
            h, (k, v, xk, xv) = _decoder_layer(lp, h, enc_out, positions,
                                               cfg, kernel=kernel)
            A.write_cache(cache["k"][i], cache["v"][i], k, v, 0, cfg,
                          cache_len)
            A.write_cache(cache["xk"][i], cache["xv"][i], xk, xv, 0, cfg,
                          cfg.encoder_seq)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return T.lm_logits(params, h[:, -1:, :], cfg), cache


def decode_step(params, cache, token, pos: int, cfg: ModelConfig):
    """token (B, 1); returns ``(logits (B, 1, V), cache)``, the
    self-attention cache updated in place."""
    h = T.embed_tokens(params, token, cfg)
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=token.device)
    cache_len = cache.get("cache_len", cache["k"].shape[2])
    for i, lp in enumerate(params["decoder"]):
        x = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = A.qkv_project(lp["attn"], x, positions, cfg)
        A.write_cache(cache["k"][i], cache["v"][i], k, v, pos, cfg,
                      cache_len)
        o = A.cached_attention(q, cache["k"][i], cache["v"][i], pos + 1,
                               cfg, cache_len)
        h = h + A.out_project(lp["attn"], o)
        q, _ = _cross_q(lp, h, cfg)
        if shd.active_grid() is None:
            o = A.full_attention(q, cache["xk"][i], cache["xv"][i])
        else:
            o = A.cached_attention(q, cache["xk"][i], cache["xv"][i],
                                   cfg.encoder_seq, cfg, cfg.encoder_seq)
        h = h + A.out_project(lp["xattn"], o)
        x = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + L.ffn(lp["ffn"], x, cfg.activation)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return T.lm_logits(params, h, cfg), cache
