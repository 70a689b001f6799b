"""Shared layers: the parameter tree, norms, RoPE, FFN, embeddings — with
logical axes, as in the JAX package's ``models/layers.py``.

A model's parameters form a tree of :class:`ParamNode` modules that mirrors
the JAX package's parameter dict key for key: a node holds named leaf
parameters (each with its logical axes and its init rule) and child nodes,
and reads like a dict (``p["wq"]``, ``"bq" in p``).  The compute functions
are plain functions on tensors and on such nodes; each reads a weight in
the compute dtype where the JAX package casts it (:func:`use`).  A served
model reads a tree whose weights are already in the compute dtype
(:func:`compute_state`, kept by the model), so those casts are no-ops.

On a grid of ranks (``dist.sharding.RankGrid`` or ``TracedGrid``) a node
holds each leaf's block under the grid's rules, and :func:`use` casts the
block and then gathers its FSDP dims (the wire carries the compute
dtype), leaving the tensor-parallel dims on ``model`` as blocks: the
products are Megatron's column- and row-parallel ones (``copy_to`` in,
``reduce_from`` out), the embedding a vocab-parallel lookup and the loss
a cross-entropy over vocab shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import sharding as shd


# --------------------------------------------------------------------------
# the parameter tree
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, logical axes and init rule — ``("normal",
    scale)``, ``("zeros",)``, ``("ones",)`` or ``("log_linspace", lo,
    hi)``.  ``keep_float32`` marks a parameter the math reads in float32
    (the SSM's ``a_log``, ``dt_bias``, ``d_skip``, ``norm_scale``); every
    other one is cast to the compute dtype wherever it is used."""
    shape: tuple
    axes: tuple
    init: tuple
    keep_float32: bool = False


class ParamNode(nn.Module):
    """A node of the parameter tree: leaf parameters and child nodes, in
    the order they were given, read by key like the JAX package's dicts.

    On a grid of ranks (``mesh=``) each leaf is held at its local shape,
    the block of the rank's coordinates under the grid's ``param_spec``
    (the JAX rules' spec, divisibility fallback included); the init fills
    it with that block of the one-process init's draw."""

    def __init__(self, leaves: dict | None = None,
                 children: dict | None = None, *, dtype=torch.float32,
                 device="cpu", mesh=None):
        super().__init__()
        self._leaves: dict[str, Leaf] = {}
        self._order: list[str] = []
        self._slices: dict[str, tuple] = {}
        self._specs: dict[str, tuple] = {}
        for name, leaf in (leaves or {}).items():
            self._leaves[name] = leaf
            self._order.append(name)
            self.register_parameter(name, nn.Parameter(
                torch.empty(self._place(name, mesh), dtype=dtype,
                            device=device), requires_grad=False))
        for name, child in (children or {}).items():
            self._order.append(name)
            self.add_module(name, child)

    def _place(self, name: str, mesh) -> tuple:
        """Records leaf ``name``'s spec and block on ``mesh`` → its local
        shape."""
        leaf = self._leaves[name]
        spec = () if mesh is None else mesh.param_spec(leaf.shape, leaf.axes)
        self._specs[name] = spec
        self._slices.pop(name, None)
        if not spec:
            return leaf.shape
        self._slices[name] = mesh.local_slice(leaf.shape, spec)
        return mesh.local_shape(leaf.shape, spec)

    def spec(self, name: str) -> tuple:
        """Leaf ``name``'s spec on the node's grid (() off a grid)."""
        return self._specs.get(name, ())

    def leaf(self, name: str) -> Leaf:
        return self._leaves[name]

    @torch.no_grad()
    def relayout_(self, old, new, extra=()) -> None:
        """Re-lays every leaf under this node from grid ``old`` onto grid
        ``new`` (None on a rank outside it): each leaf whole from the
        blocks of every rank of ``old`` (``gather_whole``, collective over
        ``old``: every one of its ranks calls it), then its block on
        ``new``.  ``extra`` (dicts name → block, keyed as
        ``named_parameters``) are re-laid alike, in place."""
        for prefix, mod in self.named_modules():
            if not isinstance(mod, ParamNode):
                continue
            for k in mod._leaves:
                name = f"{prefix}.{k}" if prefix else k
                spec = mod.spec(k)
                blocks = [getattr(mod, k)] + [d[name] for d in extra]
                whole = [old.gather_whole(b, spec) for b in blocks]
                shape = mod._place(k, new)
                if new is None:
                    continue
                sl = mod._slices.get(k, (slice(None),) * len(shape))
                mod._parameters[k] = nn.Parameter(
                    whole[0][sl].contiguous(), requires_grad=False)
                for d, w in zip(extra, whole[1:]):
                    d[name] = w[sl].contiguous()

    def __getitem__(self, key):
        if key not in self._order:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._order

    def axes(self) -> dict:
        """The logical-axes tree under this node (tuples at the leaves)."""
        return {k: (self._leaves[k].axes if k in self._leaves
                    else self[k].axes()) for k in self._order}

    def abstract(self) -> dict:
        """The parameter tree under this node as ``meta`` tensors."""
        return {k: (torch.empty(self._leaves[k].shape, device="meta")
                    if k in self._leaves else self[k].abstract())
                for k in self._order}

    def sliced(self) -> dict:
        """The leaves held as a block of their shape (on a grid): name →
        the block's slices."""
        return dict(self._slices)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Fills every parameter under this node from ``gen``, in order.  A
        sliced leaf draws its whole shape and keeps its block, so the
        generator advances as on one process."""
        for k in self._order:
            if k not in self._leaves:
                self[k].init_(gen)
                continue
            p, leaf = getattr(self, k), self._leaves[k]
            rule, block = leaf.init, self._slices.get(k)
            if rule[0] == "normal":
                full = rule[1] * torch.randn(leaf.shape, generator=gen,
                                             dtype=torch.float32,
                                             device=p.device)
                p.copy_(full if block is None else full[block])
                del full
            elif rule[0] == "zeros":
                p.zero_()
            elif rule[0] == "ones":
                p.fill_(1.0)
            elif rule[0] == "log_linspace":
                full = torch.log(torch.linspace(
                    rule[1], rule[2], leaf.shape[0], dtype=torch.float32,
                    device=p.device))
                p.copy_(full if block is None else full[block])
            else:
                raise ValueError(f"unknown init rule {rule!r}")


def normal(shape, axes, scale) -> Leaf:
    return Leaf(tuple(shape), tuple(axes), ("normal", float(scale)))


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``, as the JAX package's ``p.astype(dtype)`` at a use
    site."""
    return p if p.dtype == dtype else p.to(dtype)


def use(p, name: str, dtype=None, *, partial: bool | None = None):
    """Leaf ``name`` of node ``p`` (a :class:`ParamNode`, or a dict of
    tensors) in ``dtype``, as a rank uses it: on a grid, its block cast
    and then gathered over the axes the batch's rows split over
    (``dist.sharding.gather_leaf``; ``partial`` overrides whether its
    gradient comes back reduce-scattered), its tensor-parallel dims left
    as blocks."""
    w = p[name]
    if dtype is not None:
        w = cast(w, dtype)
    spec = p.spec(name) if isinstance(p, ParamNode) else ()
    if not spec:
        return w
    grid = shd.active_grid()
    if grid is None:
        raise ValueError(f"{name} is a rank's block of a grid: run the model "
                         f"under activation_sharding(grid, rules, batch=...)")
    return shd.gather_leaf(w, spec, p.leaf(name).axes, grid,
                           partial=partial)


def full_dim(p, name: str, dim: int) -> int:
    """The whole size of dim ``dim`` of leaf ``name`` of ``p``."""
    if isinstance(p, ParamNode):
        return p.leaf(name).shape[dim]
    return p[name].shape[dim]


def tp_split(p, name: str, w, dim: int):
    """The active grid when ``w`` (leaf ``name`` of ``p`` as :func:`use`
    gives it) is a block of ``dim`` on ``model`` — a tensor-parallel
    product — else None."""
    grid = shd.active_grid()
    if grid is None or w.shape[dim] == full_dim(p, name, dim):
        return None
    return grid

def compute_state(node: ParamNode, dtype: torch.dtype) -> dict:
    """The state dict of ``node``'s tree with every parameter that its uses
    cast to ``dtype`` copied once into ``dtype``; the ``keep_float32`` ones
    are the very same tensors.  Read through this tree, the compute
    functions give the numbers they give on the tree itself."""
    out = {}
    for prefix, mod in node.named_modules():
        if not isinstance(mod, ParamNode):
            continue
        for k, leaf in mod._leaves.items():
            p = getattr(mod, k)
            keep = leaf.keep_float32 or p.dtype == dtype
            out[f"{prefix}.{k}" if prefix else k] = (
                p if keep else p.detach().to(dtype))
    return out


# --------------------------------------------------------------------------
# dense
# --------------------------------------------------------------------------
def dense_leaves(in_dim: int, out_dim: int, in_axis, out_axis) -> dict:
    """Kernel of shape (in_dim, out_dim) with fan-in init."""
    return {"kernel": normal((in_dim, out_dim), (in_axis, out_axis),
                             1.0 / np.sqrt(in_dim))}


def matmul_in(x, w):
    """``einsum("...d,d*->...*", x, w)``: x's last dim against w's first,
    w's other dims kept."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def dense(p, x):
    """x (..., d) against kernel (d, *out) → (..., *out).  Column-parallel
    on a grid where the kernel's output dims are a block on ``model``: the
    output is gathered whole."""
    w = use(p, "kernel", x.dtype)
    grid = tp_split(p, "kernel", w, -1)
    if grid is None:
        return matmul_in(x, w)
    out = matmul_in(shd.copy_to(x, grid), w)
    return shd.gather(out, grid, "model", -1)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_leaves(d: int) -> dict:
    return {"scale": Leaf((d,), (None,), ("ones",))}


def rmsnorm(p, x, eps: float):
    # the variance accumulates in float32, as the JAX package's dot with
    # preferred_element_type=float32 does
    xf = x.to(torch.float32)
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)  # (..., 1), rowwise
    return x * inv * use(p, "scale", x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta: float):
    """x (..., S, H, D); positions (..., S) int."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(d, theta)).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# FFN (SwiGLU / GELU)
# --------------------------------------------------------------------------
def ffn_leaves(d: int, d_ff: int, activation: str) -> dict:
    leaves = {"wi": normal((d, d_ff), (shd.FSDP, shd.TENSOR), 1 / np.sqrt(d))}
    if activation == "swiglu":
        leaves["wg"] = normal((d, d_ff), (shd.FSDP, shd.TENSOR),
                              1 / np.sqrt(d))
    leaves["wo"] = normal((d_ff, d), (shd.TENSOR, shd.FSDP),
                          1 / np.sqrt(d_ff))
    return leaves


_BSF = (shd.BATCH, None, shd.TENSOR)  # ffn hidden


def ffn(p, x, activation: str):
    """Column-parallel ``wi`` / ``wg`` and row-parallel ``wo`` on a grid
    where d_ff is a block on ``model``."""
    dt = x.dtype
    wi = use(p, "wi", dt)
    grid = tp_split(p, "wi", wi, -1)
    x = shd.copy_to(x, grid)
    if activation == "swiglu":
        h = F.silu(matmul_in(x, wi))
        g = matmul_in(x, use(p, "wg", dt))
        out = matmul_in(shd.constrain(h * g, _BSF), use(p, "wo", dt))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(matmul_in(x, wi), approximate="tanh")
        out = matmul_in(shd.constrain(h, _BSF), use(p, "wo", dt))
    return shd.reduce_from(out, grid)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed_leaves(vocab: int, d: int) -> dict:
    return {"table": normal((vocab, d), (shd.VOCAB, None), 1.0)}


def vocab_lo(p, table) -> int:
    """The first vocabulary row of ``table`` (leaf ``table`` of ``p`` as
    :func:`use` gives it): 0 unless it is a block on ``model``."""
    grid = tp_split(p, "table", table, 0)
    return 0 if grid is None else grid.model_index * table.shape[0]


def embed(p, tokens, dtype, *, iota: bool = False):
    """The lookup; on a grid whose ``model`` axis holds a block of the
    vocabulary, vocab-parallel: a token outside the rank's rows reads 0,
    and the rows are summed over ``model`` (exact: one term is
    nonzero)."""
    table = use(p, "table", dtype)
    grid = tp_split(p, "table", table, 0)
    ids = tokens.long()
    if grid is None:
        if iota:
            # the one-hot matmul form (the JAX package's GSPMD-friendly
            # lookup)
            oh = F.one_hot(ids, table.shape[0]).to(dtype)
            return oh @ table
        return table[ids]
    n = table.shape[0]
    local = ids - vocab_lo(p, table)
    if iota:
        oh = (local[..., None] == torch.arange(n, device=ids.device))
        out = oh.to(dtype) @ table
    else:
        inside = (local >= 0) & (local < n)
        out = table[local.clamp(0, n - 1)] * inside[..., None].to(dtype)
    return shd.reduce_from(out, grid)


def unembed(p, x):
    """Logits ``x @ tableᵀ``: on a grid, the rank's vocabulary block
    (``vocab_lo``), ``x`` entering through ``copy_to``."""
    table = use(p, "table", x.dtype)
    return shd.copy_to(x, tp_split(p, "table", table, 0)) @ table.T


class BF16Cotangent(torch.autograd.Function):
    """Identity whose cotangent is rounded through bf16 (the JAX package's
    ``bf16_cotangent`` ``custom_vjp``): placed at layer boundaries it makes
    the backward chain travel in bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def maybe_bf16_cotangent(x, enabled: bool):
    return BF16Cotangent.apply(x) if enabled else x


def cross_entropy(logits, labels, *, z_loss: float = 1e-4, grid=None,
                  lo: int = 0):
    """Mean CE over tokens with a z-loss, in float32.  With ``grid``,
    ``logits`` are the rank's vocabulary block from row ``lo``: the
    logsumexp's max is a MAX over ``model``, the exp-sum and the target
    logit SUMs (``reduce_from``)."""
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()  # JAX's stop_gradient
    if grid is not None:
        m = grid.all_reduce(m.contiguous(), "max", axis="model")
    shifted = lf - m
    se = torch.exp(shifted).sum(dim=-1)
    ids = labels.long()
    if grid is None:
        gold = torch.take_along_dim(lf, ids[..., None], dim=-1)[..., 0]
    else:
        n = lf.shape[-1]
        local = ids - lo
        inside = ((local >= 0) & (local < n)).to(lf.dtype)
        gold = torch.take_along_dim(lf, local.clamp(0, n - 1)[..., None],
                                    dim=-1)[..., 0] * inside
        se, gold = shd.reduce_from(se, grid), shd.reduce_from(gold, grid)
    lse = torch.log(se) + m[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * (lse * lse).mean()
    return loss


def vocab_argmax(logits, full: int):
    """The index of the largest logit over the last dim, ties to the
    smallest index (``torch.argmax``'s): on a grid whose ``model`` axis
    holds a block of the ``full`` vocabulary, a MAX over ``model`` of the
    ranks' largest values and a MIN of the indices that reach it."""
    grid = shd.active_grid()
    n = logits.shape[-1]
    if grid is None or n == full:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits, dim=-1)
    best = grid.all_reduce(val.clone(), "max", axis="model")
    idx = torch.where(val == best, idx + grid.model_index * n,
                      torch.full_like(idx, full))
    return grid.all_reduce(idx, "min", axis="model")


def vocab_whole(logits, full: int):
    """``logits`` over the whole ``full`` vocabulary: a block on ``model``
    gathered."""
    grid = shd.active_grid()
    if grid is None or logits.shape[-1] == full:
        return logits
    return shd.gather(logits, grid, "model", -1)
