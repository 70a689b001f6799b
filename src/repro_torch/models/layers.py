"""Shared layers: the parameter tree, norms, RoPE, FFN, embeddings — with
logical axes, as in the JAX package's ``models/layers.py``.

A model's parameters form a tree of :class:`ParamNode` modules that mirrors
the JAX package's parameter dict key for key: a node holds named leaf
parameters (each with its logical axes and its init rule) and child nodes,
and reads like a dict (``p["wq"]``, ``"bq" in p``).  The compute functions
are plain functions on tensors and on such nodes; each casts a weight to
the compute dtype where the JAX package does (:func:`cast`).  A served
model reads a tree whose weights are already in the compute dtype
(:func:`compute_state`, kept by the model), so those casts are no-ops.
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

    On a ``dist.sharding.RankGrid`` (``mesh=``) each leaf is held at its
    local shape, the block of the rank's coordinates under
    ``RankGrid.param_spec`` (the experts' dim on the model axis); the
    init fills it with that block of the one-process init's draw."""

    def __init__(self, leaves: dict | None = None,
                 children: dict | None = None, *, dtype=torch.float32,
                 device="cpu", mesh=None):
        super().__init__()
        self._leaves: dict[str, Leaf] = {}
        self._order: list[str] = []
        self._slices: dict[str, tuple] = {}
        for name, leaf in (leaves or {}).items():
            self._leaves[name] = leaf
            self._order.append(name)
            shape = leaf.shape
            spec = () if mesh is None else mesh.param_spec(shape, leaf.axes)
            if spec:
                self._slices[name] = mesh.local_slice(shape, spec)
                shape = mesh.local_shape(shape, spec)
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))
        for name, child in (children or {}).items():
            self._order.append(name)
            self.add_module(name, child)

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
    """x (..., d) against kernel (d, *out) → (..., *out)."""
    return matmul_in(x, cast(p["kernel"], x.dtype))


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
    return x * inv * cast(p["scale"], x.dtype)


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
    dt = x.dtype
    if activation == "swiglu":
        h = F.silu(matmul_in(x, cast(p["wi"], dt)))
        g = matmul_in(x, cast(p["wg"], dt))
        return matmul_in(shd.constrain(h * g, _BSF), cast(p["wo"], dt))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(matmul_in(x, cast(p["wi"], dt)), approximate="tanh")
    return matmul_in(shd.constrain(h, _BSF), cast(p["wo"], dt))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed_leaves(vocab: int, d: int) -> dict:
    return {"table": normal((vocab, d), (shd.VOCAB, None), 1.0)}


def embed(p, tokens, dtype, *, iota: bool = False):
    table = cast(p["table"], dtype)
    if iota:
        # the one-hot matmul form (the JAX package's GSPMD-friendly lookup)
        oh = F.one_hot(tokens.long(), table.shape[0]).to(dtype)
        return oh @ table
    return table[tokens.long()]


def unembed(p, x):
    return x @ cast(p["table"], x.dtype).T


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


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Mean CE over tokens with a z-loss, in float32."""
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()  # JAX's stop_gradient
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    gold = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * (lse * lse).mean()
    return loss
