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

:class:`RankMesh` is the graph path's shard axis across
``torch.distributed`` ranks, the counterpart of the JAX package's device
mesh on the ``shard`` axis: W ranks, each holding ``local`` logical
devices, and the collectives the upper system merges with.
:class:`LocalMesh` (``LOCAL_MESH``) is the same interface for one process,
with identity collectives.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import pickle
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

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


# --------------------------------------------------------------------------
# the shard axis across ranks
# --------------------------------------------------------------------------
_REDUCE_OPS = ("sum", "min", "max")
#: how long an idle rank waits for the group's next post (the survivors may
#: run for that long without it)
IDLE_WAIT_S = 3600.0


class RankMesh:
    """The shard axis across ``torch.distributed`` ranks.

    The W ranks of the default group (the world) each hold ``local``
    logical devices on the rank's own device, so the axis spans
    m = W·local devices, as the JAX package's m devices do.  The world's
    devices are numbered as the fleet monitor numbers them: rank r hosts
    devices r·local … (r+1)·local − 1.  Rank r owns the contiguous shards
    [r·S/W, (r+1)·S/W) (:meth:`shard_range`), each of its logical devices
    S/m of them.

    A survivor mesh (:meth:`survivors`) keeps m′ of the world's devices,
    in ascending order: device i of the axis owns the shards
    [i·S/m′, (i+1)·S/m′), and the ranks hosting at least one of them form
    the mesh's process group.  A rank's ``local`` is then how many of
    them it hosts (1 or 2 of a 2 × 2 world's, say) and its shards are
    those of its devices, still contiguous since the devices are sorted.
    A world rank hosting none is *idle*: it is outside the group and
    calls none of the mesh's collectives.

    ``device`` is where the rank computes: ``cuda:{r % device_count}`` when
    None (which raises without a GPU), or what the caller passes ("cpu" in
    the tests).  Collectives, over the mesh's group:

    * :meth:`all_reduce` — a tensor on the rank's device.  Every device
      collective is an ``all_reduce`` or a ``broadcast``: gloo documents
      only those two for CUDA tensors, and several ranks on one card must
      use gloo (NCCL refuses two ranks on one GPU).
    * :meth:`all_reduce_host`, :meth:`all_gather_host` and
      :meth:`broadcast_host` — host data, over ``cpu_group``: the group
      itself when its backend is gloo, else a gloo group of the same
      ranks, made here (every world rank must construct the mesh, as
      ``torch.distributed.new_group`` requires).
    * :meth:`post` / :meth:`wait_post` — a message from the group's
      leader to the idle ranks through the world's rendezvous store: an
      idle rank waits there, for as long as the survivors run, without
      holding a collective open.

    The mesh never picks the world's backend: the caller's
    ``init_process_group`` did.
    """

    def __init__(self, *, local: int = 1, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("RankMesh needs an initialized process group "
                               "(torch.distributed.init_process_group)")
        if isinstance(local, bool) or not isinstance(local, (int, np.integer)) \
                or local < 1:
            raise ValueError(f"local must be an int >= 1 logical devices a "
                             f"rank, got {local!r}")
        self.group = dist.group.WORLD
        self.world_size = dist.get_world_size(self.group)
        self.world = self.world_size
        self.rank = dist.get_rank(self.group)
        self.local = self.world_local = int(local)
        if device is None:
            device = (f"cuda:{self.rank % torch.cuda.device_count()}"
                      if torch.cuda.is_available() else "cuda")
        self.device = resolve_device(device)
        self.backend = str(dist.get_backend(self.group))
        if self.backend == "gloo":
            self.cpu_group = self.group
        else:
            self.cpu_group = dist.new_group(
                dist.get_process_group_ranks(self.group), backend="gloo")
        self.device_ids = tuple(range(self.world_size * self.local))
        self.members = tuple(range(self.world_size))
        self.offset = self.rank * self.local
        # every mesh made from this one shares the groups already made, by
        # member ranks: the ranks make the same calls in the same order, so
        # a hit on one rank is a hit on every rank
        self._groups = {self.members: (self.group, self.cpu_group)}
        self._store = None

    @property
    def size(self) -> int:
        """m, the logical devices of the axis over every rank."""
        return len(self.device_ids)

    @property
    def idle(self) -> bool:
        """True on a world rank that hosts none of the axis' devices."""
        return self.local == 0

    def device_for(self, device=None) -> torch.device:
        """The rank's device, for a caller that was also handed
        ``device``: None, or a device of the same type (and index, if it
        names one), else ``ValueError``."""
        want = None if device is None else resolve_device(device)
        if want is not None and (want.type != self.device.type or (
                want.index is not None and want != self.device)):
            raise ValueError(f"device={device!r} differs from the "
                             f"RankMesh's {self.device}")
        return self.device

    @property
    def leader(self) -> int:
        """The group's lowest rank: it posts to the idle ranks."""
        return self.members[0]

    def survivors(self, device_ids) -> "RankMesh":
        """The mesh of the world devices ``device_ids`` — a kill's, a
        straggler's or a join's survivor axis.  Every world rank must call
        it, idle ones included, with the same ids: a group of new member
        ranks is made with ``torch.distributed.new_group``, which is
        collective over the world."""
        ids = tuple(sorted(int(d) for d in device_ids))
        total = self.world_size * self.world_local
        if not ids or len(set(ids)) != len(ids) or ids[0] < 0 \
                or ids[-1] >= total:
            raise ValueError(f"survivor devices {list(ids)} must be distinct "
                             f"ids of the world's {total}")
        members = tuple(sorted({d // self.world_local for d in ids}))
        if members not in self._groups:
            group = dist.new_group(list(members), backend=self.backend)
            cpu = (group if self.backend == "gloo" else
                   dist.new_group(list(members), backend="gloo"))
            self._groups[members] = (group, cpu)
        new = copy.copy(self)
        new.device_ids, new.members = ids, members
        new.world = len(members)
        mine = [i for i, d in enumerate(ids)
                if d // self.world_local == self.rank]
        new.local = len(mine)
        new.offset = mine[0] if mine else 0
        new.group, new.cpu_group = (self._groups[members] if mine
                                    else (None, None))
        return new

    def shard_range(self, num_shards: int) -> range:
        """The shards this rank's devices own: [o·S/m, (o+local)·S/m) for
        its first device o of the axis (the world mesh: [r·S/W,
        (r+1)·S/W)); empty on an idle rank."""
        if num_shards < 1 or num_shards % self.size:
            raise ValueError(f"{self.world} ranks x {self.local} logical "
                             f"devices (m={self.size}) must divide the "
                             f"{num_shards} shards")
        per = num_shards // self.size
        return range(self.offset * per, (self.offset + self.local) * per)

    @staticmethod
    def _op(op: str):
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {_REDUCE_OPS}, got {op!r}")
        return {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                "max": dist.ReduceOp.MAX}[op]

    def _member(self):
        if self.idle:
            raise RuntimeError(f"rank {self.rank} is idle: it is outside the "
                               f"group of {list(self.members)}")

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """Reduces ``tensor`` in place over ``group`` with ``op`` ("sum",
        "min", "max") and returns it: every rank holds the same bytes."""
        self._member()
        dist.all_reduce(tensor, op=self._op(op), group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int):
        """``tensor`` of world rank ``src`` (a member) on every member, in
        place."""
        self._member()
        dist.broadcast(tensor, src=src, group=self.group)
        return tensor

    def all_reduce_host(self, array, op: str = "sum") -> np.ndarray:
        """Reduces a host array over ``cpu_group`` → a new numpy array."""
        self._member()
        t = torch.from_numpy(np.array(array, copy=True))
        dist.all_reduce(t, op=self._op(op), group=self.cpu_group)
        return t.numpy()

    def all_gather_host(self, obj) -> list:
        """Every member's ``obj`` (picklable host data), in rank order,
        over ``cpu_group``."""
        self._member()
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def broadcast_host(self, obj, src: int):
        """World rank ``src``'s ``obj`` (picklable host data) on every
        member, over ``cpu_group``."""
        self._member()
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.cpu_group)
        return box[0]

    def post(self, key: str, obj) -> None:
        """Leaves ``obj`` under ``key`` in the world's store for
        :meth:`wait_post` (the leader's message to the idle ranks)."""
        self._world_store().set(f"repro_torch/{key}", pickle.dumps(obj))

    def wait_post(self, key: str):
        """The object posted under ``key``, once it is there (at most
        ``IDLE_WAIT_S``)."""
        store = self._world_store()
        key = f"repro_torch/{key}"
        store.wait([key], datetime.timedelta(seconds=IDLE_WAIT_S))
        return pickle.loads(store.get(key))

    def _world_store(self):
        if self._store is None:
            from torch.distributed import distributed_c10d

            self._store = distributed_c10d._get_default_store()
        return self._store

    def __repr__(self) -> str:
        return (f"RankMesh(rank={self.rank}, world={self.world}, "
                f"local={self.local}, devices={list(self.device_ids)}, "
                f"device={self.device}, backend={self.backend})")


class LocalMesh:
    """The shard axis held whole by one process: world 1, rank 0, every
    shard its own, and collectives that return their input.  The merge
    code runs over it where no :class:`RankMesh` is given, so one path
    serves one process and many ranks."""

    world = 1
    rank = offset = 0
    idle = False

    def shard_range(self, num_shards: int) -> range:
        """Every shard."""
        if num_shards < 1:
            raise ValueError(f"need at least one shard, got {num_shards}")
        return range(num_shards)

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        return tensor

    def all_reduce_host(self, array, op: str = "sum") -> np.ndarray:
        return np.asarray(array)

    def all_gather_host(self, obj) -> list:
        return [obj]

    def __repr__(self) -> str:
        return "LocalMesh()"


LOCAL_MESH = LocalMesh()
