"""Decoder-only stacks — dense, MoE, SSM (Mamba2), hybrid (Zamba2) and
VLM: the forward pass and training loss, prefill and one-token decode, as
in the JAX package's ``models/transformer.py``.

The parameters are a tree of modules (:class:`~repro_torch.models.layers.
ParamNode`): one module per layer kind (:class:`DenseLayer`,
:class:`MoELayer`, :class:`SSMLayer`), a :class:`Stack` over the layers (the JAX package
stacks them on a leading axis for its ``lax.scan``; its logical-axes tree
carries a leading ``"layers"`` axis, and so does ``Stack.axes``), and the
hybrid family's shared attention block held once.  The math is in plain
functions.  The hybrid family runs groups: ``attn_every`` Mamba2 layers,
then the shared block (one weight set, a fresh KV cache entry per
invocation).  Caches keep the JAX package's layout: stacked (layers or
groups, B, …) tensors.  Where ``cfg.remat`` is set and grad is enabled,
each layer (each group in the hybrid family) is rematerialized in the
backward pass (``torch.utils.checkpoint``, non-reentrant) as the JAX
package's ``jax.checkpoint`` does; its kernels then launch twice a step.
Serving runs without grad and is unchanged.

On a grid of ranks (``dist.sharding.RankGrid``, or the dry run's
``TracedGrid``) the stack runs on the rank's rows and parameter blocks
(``models/layers.py``), its logits are the rank's vocabulary block, and
its caches are the rank's blocks of the JAX layout (:func:`init_cache`;
the dict then also holds the whole ``"cache_len"``); greedy decoding
takes the argmax over the vocabulary's blocks (``layers.vocab_argmax``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.common import ModelConfig


# --------------------------------------------------------------------------
# the parameter tree
# --------------------------------------------------------------------------
def _node(leaves=None, children=None, *, cfg, device, mesh=None):
    return L.ParamNode(leaves, children, dtype=cfg.tparam_dtype,
                       device=device, mesh=mesh)


class DenseLayer(L.ParamNode):
    """Attention + FFN with two RMSNorms."""

    def __init__(self, cfg: ModelConfig, *, device, mesh=None):
        kw = dict(cfg=cfg, device=device, mesh=mesh)
        super().__init__(children={
            "ln1": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "attn": _node(A.attention_leaves(cfg), **kw),
            "ln2": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "ffn": _node(L.ffn_leaves(cfg.d_model, cfg.d_ff,
                                      cfg.activation), **kw),
        })


class MoELayer(L.ParamNode):
    """Attention + MoE FFN (routed experts, an optional shared expert)."""

    def __init__(self, cfg: ModelConfig, *, device, mesh=None):
        kw = dict(cfg=cfg, device=device, mesh=mesh)
        moe = {}
        if cfg.shared_expert:
            moe["shared"] = _node(L.ffn_leaves(cfg.d_model, cfg.d_ff,
                                               cfg.activation), **kw)
        super().__init__(children={
            "ln1": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "attn": _node(A.attention_leaves(cfg), **kw),
            "ln2": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "moe": _node(M.moe_leaves(cfg), moe, **kw),
        })


class SSMLayer(L.ParamNode):
    """RMSNorm + Mamba2 block."""

    def __init__(self, cfg: ModelConfig, *, device, mesh=None):
        kw = dict(cfg=cfg, device=device, mesh=mesh)
        super().__init__(children={
            "ln1": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
            "ssm": _node(S.ssm_leaves(cfg), **kw),
        })


class Stack(nn.ModuleList):
    """The layers, in order.  Its logical axes and abstract tree are the
    JAX package's stacked ones: each leaf with a leading ``"layers"`` dim."""

    def axes(self) -> dict:
        def prefix(t):
            if isinstance(t, dict):
                return {k: prefix(v) for k, v in t.items()}
            return ("layers", *t)
        return prefix(self[0].axes())

    def abstract(self) -> dict:
        def stack(t):
            if isinstance(t, dict):
                return {k: stack(v) for k, v in t.items()}
            return torch.empty((len(self), *t.shape), device="meta")
        return stack(self[0].abstract())

    def init_(self, gen: torch.Generator) -> None:
        for layer in self:
            layer.init_(gen)


def layer_kind(cfg: ModelConfig) -> str:
    return {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
            "hybrid": "ssm"}[cfg.family]


LAYERS = {"dense": DenseLayer, "moe": MoELayer, "ssm": SSMLayer}


def build(cfg: ModelConfig, *, device, mesh=None) -> dict:
    """The root's children, in the JAX package's key order (each leaf at
    its local shape on a ``RankGrid`` ``mesh``)."""
    kw = dict(cfg=cfg, device=device, mesh=mesh)
    layer = LAYERS[layer_kind(cfg)]
    children: dict[str, Any] = {
        "embed": _node(L.embed_leaves(cfg.padded_vocab, cfg.d_model), **kw),
        "layers": Stack([layer(**kw) for _ in range(cfg.num_layers)]),
        "final_norm": _node(L.rmsnorm_leaves(cfg.d_model), **kw),
    }
    if not cfg.tie_embeddings:
        children["unembed"] = _node(
            L.embed_leaves(cfg.padded_vocab, cfg.d_model), **kw)
    if cfg.family == "hybrid":
        children["shared_attn"] = DenseLayer(**kw)
    if cfg.family == "vlm":
        children["patch_proj"] = _node(L.dense_leaves(
            cfg.d_model, cfg.d_model, shd.FSDP, shd.TENSOR), **kw)
    return children


# --------------------------------------------------------------------------
# layer forward (training / prefill path)
# --------------------------------------------------------------------------
def dense_layer_fwd(p, h, positions, cfg: ModelConfig, *, kernel: str,
                    causal: bool = True):
    """Returns ``(h, (k, v), aux)``: the layer's output, its keys/values
    and its MoE load loss (0 for a dense FFN)."""
    x = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    q, k, v = A.qkv_project(p["attn"], x, positions, cfg)
    o = A.self_attention(q, *A.kv_for_q(q, k, v, cfg), causal=causal,
                         kernel=kernel)
    h = h + A.out_project(p["attn"], o)
    x = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    if "ffn" in p:
        h = h + L.ffn(p["ffn"], x, cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        y, aux = M.moe_ffn(p["moe"], x, cfg, return_aux=True)
        h = h + y
    return L.maybe_bf16_cotangent(h, cfg.bf16_cotangent), (k, v), aux


def ssm_layer_fwd(p, h, cfg: ModelConfig, *, kernel: str):
    x = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    return L.maybe_bf16_cotangent(
        h + S.ssm_forward(p["ssm"], x, cfg, kernel=kernel),
        cfg.bf16_cotangent)


def _groups(cfg: ModelConfig):
    """The hybrid family's groups: (group index, its layer indices)."""
    per = cfg.attn_every
    return [(g, range(g * per, (g + 1) * per))
            for g in range(cfg.num_layers // per)]


def maybe_remat(fn, cfg: ModelConfig):
    """``fn`` rematerialized in the backward pass where ``cfg.remat`` is set
    and grad is enabled (nothing of it is saved but its inputs), else
    ``fn`` itself.  The recomputation runs under the ``activation_sharding``
    context of the forward pass: on the card autograd runs the backward in
    a thread of its own, where the thread-local context is not."""
    def run(*args):
        if cfg.remat and torch.is_grad_enabled():
            ctx = shd.active_context()
            if ctx is None:
                return checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            batch = shd.active_batch()

            def in_context(*a):
                with shd.activation_sharding(*ctx, batch=batch):
                    return fn(*a)

            return checkpoint(in_context, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)
    return run


def stack_forward(params, h, positions, cfg: ModelConfig, *, kernel: str):
    """The layer stack; returns ``(h, aux)`` (aux summed over layers)."""
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "hybrid":
        def group(hh, idx):
            for i in idx:
                hh = ssm_layer_fwd(layers[i], hh, cfg, kernel=kernel)
            hh, _, a = dense_layer_fwd(params["shared_attn"], hh, positions,
                                       cfg, kernel=kernel)
            return hh, a

        body = maybe_remat(group, cfg)
        for _, idx in _groups(cfg):
            h, a = body(h, idx)
            aux = aux + a
        return h, aux
    if layer_kind(cfg) == "ssm":
        body = maybe_remat(
            lambda hh, lp: ssm_layer_fwd(lp, hh, cfg, kernel=kernel), cfg)
        for lp in layers:
            h = body(h, lp)
        return h, aux

    def layer(hh, lp):
        hh, _, a = dense_layer_fwd(lp, hh, positions, cfg, kernel=kernel)
        return hh, a

    body = maybe_remat(layer, cfg)
    for lp in layers:
        h, a = body(h, lp)
        aux = aux + a
    return h, aux


# --------------------------------------------------------------------------
# embedding in / out
# --------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg: ModelConfig, *, patch_embeds=None):
    dt = cfg.tdtype
    h = L.embed(params["embed"], tokens, dt, iota=cfg.iota_embed)
    h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = L.dense(params["patch_proj"], patch_embeds.to(dt))
        npatch = pe.shape[1]
        h[:, :npatch, :] += pe
    return shd.constrain(h, (shd.BATCH_DP, None, None))


def logits_lo(logits, cfg: ModelConfig) -> int:
    """The first vocabulary column of ``logits``: the rank's block's on a
    grid whose ``model`` axis splits the vocabulary, else 0."""
    n = logits.shape[-1]
    grid = shd.active_grid()
    return 0 if grid is None or n == cfg.padded_vocab \
        else grid.model_index * n


def lm_logits(params, h, cfg: ModelConfig):
    h = L.maybe_bf16_cotangent(h, cfg.bf16_cotangent)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = L.unembed(table, h)
    if cfg.padded_vocab != cfg.vocab_size:
        # padding columns carry no probability mass
        lo = logits_lo(logits, cfg)
        col = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return shd.constrain(logits, (shd.BATCH_DP, None, shd.VOCAB))


def loss_ce(logits, labels, cfg: ModelConfig):
    """The cross-entropy of ``logits`` (the rank's vocabulary block on a
    grid that splits it)."""
    lo = logits_lo(logits, cfg)
    sharded = logits.shape[-1] != cfg.padded_vocab
    return L.cross_entropy(logits, labels, lo=lo,
                           grid=shd.active_grid() if sharded else None)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params, tokens, cfg: ModelConfig, *, kernel: str,
            patch_embeds=None):
    """Returns ``(logits (B, S, V_padded), aux)``; aux is the MoE load
    loss summed over layers (0 for the other families)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = embed_tokens(params, tokens, cfg, patch_embeds=patch_embeds)
    h, aux = stack_forward(params, h, positions, cfg, kernel=kernel)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params, h, cfg), aux


def train_loss(params, batch, cfg: ModelConfig, *, kernel: str,
               aux_weight: float = 0.01, parts=None):
    """The cross-entropy (the rank's part of the global batch's mean under
    a RankGrid: ``dist.sharding.rows_share``) plus the weighted MoE loss
    (the global batch's on every rank).  ``parts``, a dict if given,
    receives both, detached (``"ce"``, ``"aux"``)."""
    logits, aux = forward(params, batch["tokens"], cfg, kernel=kernel,
                          patch_embeds=batch.get("patch_embeds"))
    ce = loss_ce(logits, batch["labels"], cfg)
    share = shd.rows_share(batch["tokens"].shape[0])
    if share != 1.0:
        ce = ce * share
    if parts is not None:
        parts["ce"], parts["aux"] = ce.detach(), (aux_weight * aux).detach()
    return ce + aux_weight * aux


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------
DEFAULT_MODEL_SHARDS = 16  # production mesh model-axis width


def kv_cache_axes(cfg: ModelConfig, *,
                  model_shards: int = DEFAULT_MODEL_SHARDS):
    """KV-cache layout policy: KV heads on the model axis when they divide
    it, else the cache's sequence dim (flash-decoding)."""
    if cfg.num_kv_heads % model_shards == 0:
        return ("layers", shd.BATCH, None, shd.KV_HEADS, None)
    return ("layers", shd.BATCH, shd.KV_SEQ, None, None)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               grid=None):
    """Decode cache skeleton (zeros) and its logical axes: ``batch`` rows
    of ``cache_len`` positions — on ``grid``, the rank's rows and its
    block of the rest, and ``"cache_len"`` beside the tensors."""
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    dt = cfg.tdtype
    kv_axes = kv_cache_axes(cfg)
    cache: dict[str, Any] = {}
    axes: dict[str, Any] = {}

    def zeros(shape, ax, dtype=dt):
        return torch.zeros(shd.rows_block_shape(shape, ax, grid), dtype=dtype,
                           device=device)

    if layer_kind(cfg) in ("dense", "moe"):
        shape = (cfg.num_layers, batch, cache_len, hkv, hd)
        cache = {"k": zeros(shape, kv_axes), "v": zeros(shape, kv_axes)}
        axes = {"k": kv_axes, "v": kv_axes}
    else:
        one = S.init_ssm_cache(cfg, batch, dt, device)
        axes = {k: ("layers", *ax) for k, ax in S.ssm_cache_axes(cfg).items()}
        cache = {k: zeros((cfg.num_layers, *x.shape), axes[k], x.dtype)
                 for k, x in one.items()}
        if cfg.family == "hybrid":
            shape = (cfg.num_layers // cfg.attn_every, batch, cache_len, hkv,
                     hd)
            cache["k"] = zeros(shape, kv_axes)
            cache["v"] = zeros(shape, kv_axes)
            axes["k"] = kv_axes
            axes["v"] = kv_axes
    if grid is not None:
        cache["cache_len"] = cache_len
    return cache, axes


def prefill(params, tokens, cfg: ModelConfig, *, kernel: str,
            cache_len: int | None = None, patch_embeds=None):
    """Processes the prompt; returns ``(last-position logits (B, 1, V),
    cache)``.  Keys and values are padded to ``cache_len`` positions."""
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len={cache_len} is shorter than the "
                         f"prompt ({s})")
    positions = _positions(b, s, tokens.device)
    h = embed_tokens(params, tokens, cfg, patch_embeds=patch_embeds)
    cache, _ = init_cache(cfg, b, cache_len, tokens.device,
                          shd.active_grid())
    layers = params["layers"]

    def ssm_prefill_layer(i, hh):
        x = L.rmsnorm(layers[i]["ln1"], hh, cfg.norm_eps)
        y, c = S.ssm_prefill(layers[i]["ssm"], x, cfg, kernel=kernel)
        cache["ssm"][i] = c["ssm"]
        cache["conv"][i] = c["conv"]
        return hh + y

    if cfg.family == "hybrid":
        for g, idx in _groups(cfg):
            for i in idx:
                h = ssm_prefill_layer(i, h)
            h, (k, v), _ = dense_layer_fwd(params["shared_attn"], h,
                                           positions, cfg, kernel=kernel)
            A.write_cache(cache["k"][g], cache["v"][g], k, v, 0, cfg,
                          cache_len)
    elif layer_kind(cfg) in ("dense", "moe"):
        for i, lp in enumerate(layers):
            h, (k, v), _ = dense_layer_fwd(lp, h, positions, cfg,
                                           kernel=kernel)
            A.write_cache(cache["k"][i], cache["v"][i], k, v, 0, cfg,
                          cache_len)
    else:  # ssm
        for i in range(len(layers)):
            h = ssm_prefill_layer(i, h)

    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params, h[:, -1:, :], cfg), cache


def _attn_decode(p, h, k_cache, v_cache, pos: int, cfg: ModelConfig,
                 cache_len: int):
    """One-token attention with the cache updated in place. h (B, 1, D)."""
    x = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    q, k, v = A.qkv_project(p["attn"], x, positions, cfg)
    A.write_cache(k_cache, v_cache, k, v, pos, cfg, cache_len)
    o = A.cached_attention(q, k_cache, v_cache, pos + 1, cfg, cache_len)
    h = h + A.out_project(p["attn"], o)
    x = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    if "ffn" in p:
        return h + L.ffn(p["ffn"], x, cfg.activation)
    return h + M.moe_ffn(p["moe"], x, cfg)


def decode_step(params, cache, token, pos: int, cfg: ModelConfig):
    """token (B, 1) int; ``pos`` the position being generated.  Returns
    ``(logits (B, 1, V), cache)``; the cache is updated in place (the JAX
    package's ``launch/serve.py`` donates it to the step)."""
    h = embed_tokens(params, token, cfg)
    layers = params["layers"]
    cache_len = cache.get("cache_len")
    if cache_len is None and "k" in cache:
        cache_len = cache["k"].shape[2]

    def ssm_decode_layer(i, hh):
        x = L.rmsnorm(layers[i]["ln1"], hh, cfg.norm_eps)
        y, c = S.ssm_decode_step(
            layers[i]["ssm"], x,
            {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, cfg)
        cache["ssm"][i] = c["ssm"]
        cache["conv"][i] = c["conv"]
        return hh + y

    if cfg.family == "hybrid":
        for g, idx in _groups(cfg):
            for i in idx:
                h = ssm_decode_layer(i, h)
            h = _attn_decode(params["shared_attn"], h, cache["k"][g],
                             cache["v"][g], pos, cfg, cache_len)
    elif layer_kind(cfg) in ("dense", "moe"):
        for i, lp in enumerate(layers):
            h = _attn_decode(lp, h, cache["k"][i], cache["v"][i], pos, cfg,
                             cache_len)
    else:  # ssm
        for i in range(len(layers)):
            h = ssm_decode_layer(i, h)

    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params, h, cfg), cache
