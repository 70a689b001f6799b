"""Logical-axis sharding rules (intra-iteration partitioning), as in the JAX
package's ``dist/sharding.py``.

Model code never names mesh axes.  Parameters and activations carry tuples
of *logical* axis names (``(FSDP, TENSOR)``, ``(BATCH, None, None)``, …);
a rule table built per mesh maps each logical name to zero or more mesh
axes.  ``spec_for`` resolves a concrete shape against the table with two
safety properties:

* **divisibility fallback** — a dimension whose size does not divide the
  mapped mesh-axis product replicates instead of sharding;
* **no mesh axis used twice** — within one tensor, the first dimension to
  claim a mesh axis wins and later dimensions replicate.

A spec is a plain tuple that reads like JAX's ``PartitionSpec``: one entry
per leading dimension (a mesh-axis name, a tuple of them, or None),
trailing replicated dimensions trimmed.  ``placements_for`` turns one into
``torch.distributed.tensor`` placements (``Shard(i)`` / ``Replicate()`` per
mesh axis).  Every function takes any mesh that has ``axis_names`` and
``shape`` (a name → size mapping); a ``DeviceMesh`` is read through
``mesh_dim_names`` and its size.

``constrain`` is the activation-side entry point.  The port runs a model
on one card, where every tensor lies whole on the one device: ``constrain``
returns the very same tensor, outside and inside an
``activation_sharding`` context (which only records the active mesh and
rules, thread-locally, for code that asks ``active_context``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Sequence

# --------------------------------------------------------------------------
# logical axis names
# --------------------------------------------------------------------------
BATCH = "batch"          # batch dim of activations (data-parallel axes)
BATCH_DP = "batch_dp"    # batch dim on pod/data axes only, even under fsdp
FSDP = "fsdp"            # weight dim sharded over the data-parallel axes
TENSOR = "tensor"        # weight/activation dim sharded over "model" (TP)
HEADS = "heads"          # query-head dim (TP)
KV_HEADS = "kv_heads"    # KV-head dim (TP; GQA groups)
KV_SEQ = "kv_seq"        # KV-cache sequence dim (flash-decoding split)
VOCAB = "vocab"          # vocabulary dim (embed table / logits)
EXPERT = "expert"        # MoE expert dim
CAPACITY = "capacity"    # MoE dispatch-buffer capacity dim (data axes)

LOGICAL_AXES = (BATCH, BATCH_DP, FSDP, TENSOR, HEADS, KV_HEADS, KV_SEQ,
                VOCAB, EXPERT, CAPACITY)

STRATEGIES = ("2d", "fsdp", "serve")


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"mesh {mesh!r} has no axis_names")
    return tuple(names)


def _axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return int(shape[name])
    # a DeviceMesh: shape is a tuple in axis-name order
    return int(tuple(shape)[_axis_names(mesh).index(name)])


# --------------------------------------------------------------------------
# rule tables
# --------------------------------------------------------------------------
def make_rules(mesh, *, strategy: str = "2d") -> dict[str, tuple[str, ...]]:
    """Logical-axis → mesh-axes table for ``mesh`` under ``strategy``.

    * ``"2d"``   — FSDP × TP: weights shard (pod, data) × model, batch
                   shards the data axes.
    * ``"fsdp"`` — pure data parallel over the whole mesh.
    * ``"serve"``— TP only: weights replicate across data.

    Only axes present in the mesh's axis names are emitted."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{STRATEGIES}")
    names = _axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    everything = dp + tp

    if strategy == "fsdp":
        return {
            BATCH: everything, BATCH_DP: dp, FSDP: everything,
            TENSOR: (), HEADS: (), KV_HEADS: (), KV_SEQ: (),
            VOCAB: tp, EXPERT: tp, CAPACITY: dp,
        }
    if strategy == "serve":
        return {
            BATCH: dp, BATCH_DP: dp, FSDP: (),
            TENSOR: tp, HEADS: tp, KV_HEADS: tp, KV_SEQ: tp,
            VOCAB: tp, EXPERT: tp, CAPACITY: dp,
        }
    return {  # "2d"
        BATCH: dp, BATCH_DP: dp, FSDP: dp,
        TENSOR: tp, HEADS: tp, KV_HEADS: tp, KV_SEQ: tp,
        VOCAB: tp, EXPERT: tp, CAPACITY: dp,
    }


def _mesh_axes_for(rules: Mapping[str, Sequence[str]], name) -> tuple:
    """Mesh axes for one logical name; unknown names (e.g. "layers") map
    to none, and an explicit mesh-axis tuple passes through."""
    if name is None:
        return ()
    if isinstance(name, tuple):  # pre-resolved mesh axes
        return name
    got = rules.get(name, ())
    if got is None:
        return ()
    return (got,) if isinstance(got, str) else tuple(got)


# --------------------------------------------------------------------------
# spec construction
# --------------------------------------------------------------------------
def spec_for(shape: Sequence[int], axes, mesh, rules) -> tuple:
    """The spec for ``shape`` whose dims carry logical names ``axes``.

    Per dimension the rule table maps the logical name to mesh axes; axes
    an earlier dimension claimed are dropped, and if the remaining
    mesh-axis product does not divide the dimension it replicates.
    Trailing replicated dims are trimmed, so ``spec_for((4n, 8), (TENSOR,
    None)) == ("model",)``."""
    if axes is None:
        axes = (None,) * len(shape)
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {tuple(shape)}")
    used: set[str] = set()
    parts: list[Any] = []
    for dim, name in zip(shape, axes):
        mesh_axes = tuple(a for a in _mesh_axes_for(rules, name)
                          if a not in used)
        prod = 1
        for a in mesh_axes:
            prod *= _axis_size(mesh, a)
        if mesh_axes and dim % prod == 0:
            used.update(mesh_axes)
            parts.append(mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Sequence, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``: one
    per mesh axis, in axis-name order — ``Shard(i)`` for the tensor dim
    ``i`` that claims the axis, ``Replicate()`` otherwise.  A dim that
    claims several mesh axes shards over each of them."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    dim_of: dict[str, int] = {}
    for i, part in enumerate(spec):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            if a not in names:
                raise ValueError(f"spec axis {a!r} is not in the mesh's "
                                 f"{names}")
            if a in dim_of:
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


def tree_specs(tree, axes, mesh, rules):
    """Maps ``spec_for`` over a tree of tensors (dicts, lists, tuples of
    them; anything with ``shape`` is a leaf) and its parallel tree of
    logical-axes tuples — the counterpart of JAX's ``tree_shardings``."""
    if isinstance(tree, Mapping):
        if set(tree) != set(axes):
            raise ValueError(f"axes keys {sorted(axes)} do not match the "
                             f"tree's {sorted(tree)}")
        return {k: tree_specs(tree[k], axes[k], mesh, rules) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        if len(tree) != len(axes):
            raise ValueError("axes do not match the tree's length")
        return type(tree)(tree_specs(t, a, mesh, rules)
                          for t, a in zip(tree, axes))
    return spec_for(tuple(tree.shape), axes, mesh, rules)


# --------------------------------------------------------------------------
# activation-sharding context
# --------------------------------------------------------------------------
_local = threading.local()


def active_context():
    """The innermost ``(mesh, rules)`` pushed by ``activation_sharding``,
    or None outside any context."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activation_sharding(mesh, rules):
    """Records ``(mesh, rules)`` as the active context for this thread."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append((mesh, rules))
    try:
        yield
    finally:
        stack.pop()


def constrain(x, axes):
    """Constrains activation ``x`` to its logical axes.  On one card the
    whole tensor lies on the one device, so this returns the very same
    object, with or without an ``activation_sharding`` context."""
    return x
