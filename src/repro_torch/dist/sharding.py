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

``constrain`` is the activation-side entry point.  A rank's activations
are its own tensors, whole on its device: ``constrain`` returns the very
same tensor, outside and inside an ``activation_sharding`` context (which
records the active mesh, rules and global batch rows, thread-locally, for
code that asks ``active_context`` / ``active_batch``).

:class:`RankGrid` is the model path's (pod, data, model) mesh across
ranks, and :class:`TracedGrid` one rank of such a grid with no process
group, for the dry run.  Both lay every parameter out as the JAX rules
say under the grid's strategy (``param_spec``, divisibility fallback
included): FSDP on the data axes and TENSOR, HEADS, KV_HEADS, KV_SEQ,
VOCAB and EXPERT on ``model`` under ``"2d"``; the batch's rows split over
BATCH's axes.  Their collectives (``all_reduce``, ``all_gather``,
``reduce_scatter`` along an axis) report themselves to the op counters as
NCCL's kinds; the autograd Functions below carry them through the
models: ``copy_to`` / ``reduce_from`` (Megatron's "f" and "g"),
``gather`` (the FSDP gather: its backward reduce-scatters, or takes the
rank's block where every rank used the whole alike), ``take_block`` /
``gather_blocks``, and ``gather_leaf`` / ``fit_block``, which cut a
leaf's block to what a rank computes with.

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
    return stack[-1][:2] if stack else None


def active_batch():
    """The global batch rows the innermost ``activation_sharding`` context
    was given (``batch=``), or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1][2] if stack else None


@contextlib.contextmanager
def activation_sharding(mesh, rules, *, batch: int | None = None):
    """Records ``(mesh, rules)`` as the active context for this thread.

    Under a grid of ranks the activations are a rank's own: ``batch``
    names the rows of the global batch they belong to, and a rank holds
    its shard of them when the batch axes divide ``batch``
    (:meth:`RankGrid.rows_split`), else all of them.  The layers (whether
    a gradient is a part), the MoE's layout and the loss's normalisation
    read it (``active_batch``)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append((mesh, rules, batch))
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


class _WorldPost:
    """Messages from a group's leader to the idle ranks through the
    world's rendezvous store: an idle rank waits there, for as long as the
    survivors run, without holding a collective open."""

    _store = None

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


class RankMesh(_WorldPost):
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


# --------------------------------------------------------------------------
# the (data, model) grid of ranks
# --------------------------------------------------------------------------
#: the data-parallel axes of a grid, outermost first
DATA_AXES = ("pod", "data")
#: ranks a node of the card's machines holds (a DGX H100's eight GPUs),
#: for the links a group of ranks spans
RANKS_PER_NODE = 8


def axis_key(grid, mesh_axes) -> str | None:
    """The grid axis a spec entry's mesh axes name: ``"model"``,
    ``"data"`` (every data axis) or None (every axis)."""
    got = set(mesh_axes)
    if got == set(grid.axis_names):
        return None
    if got == {"model"}:
        return "model"
    if got == set(grid.axis_names) - {"model"}:
        return "data"
    raise ValueError(f"mesh axes {tuple(mesh_axes)} name no axis of a "
                     f"{grid.shape} grid")


class _Grid:
    """The layout and the collectives a (pod, data, model) grid of ranks
    shares, whether its ranks are processes (:class:`RankGrid`) or one
    rank traced on the meta device (:class:`TracedGrid`).

    Ranks are row-major, as ``jax.make_mesh`` lays out devices (rank =
    d·mp + r).  ``strategy`` picks the rule table (:func:`make_rules`):
    a parameter's spec is :func:`spec_for` of its shape and logical axes
    under the grid's own rules (:meth:`param_spec`), with the JAX
    package's divisibility fallback, and a rank holds its block of it
    (:meth:`local_slice`).  A batch's rows split over the axes ``BATCH``
    maps to (the data axes, every axis under ``"fsdp"``) when they divide
    them (:meth:`rows_split`, :meth:`local_rows`).

    Collectives over an axis (``"model"``: the rank's data row;
    ``"data"``: its model column over every data axis; None: the grid):
    :meth:`all_reduce` (in place), :meth:`all_gather` and
    :meth:`reduce_scatter` along any dim.  Under gloo, which takes CUDA
    tensors for ``all_reduce`` and ``broadcast`` only, the gather is a SUM
    of zero-padded blocks (exact) and the reduce-scatter an ``all_reduce``
    and the rank's block; under NCCL they are ``all_gather_into_tensor``
    and ``reduce_scatter_tensor``.  Both give the same numbers.  Each
    reports itself to the open op counters (``kernels/accounting``) as
    the collective NCCL runs — its kind, result bytes, group size and
    axis — and the emulation's tensor work is traced as it runs."""

    def _layout(self, shape: Mapping[str, int], strategy: str) -> None:
        self.shape = {k: int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        if self.axis_names[-1] != "model" or not set(self.axis_names[:-1]) \
                <= set(DATA_AXES) or "data" not in self.axis_names:
            raise ValueError(f"a grid's axes are (pod,) data, model; got "
                             f"{self.axis_names}")
        self.size = int(np.prod(list(self.shape.values())))
        self.mp = self.shape["model"]
        self.dp = self.size // self.mp
        self.strategy = strategy
        self.rules = make_rules(self, strategy=strategy)
        batch_axes = _mesh_axes_for(self.rules, BATCH)
        self.row_axis = axis_key(self, batch_axes) if batch_axes else None
        self.row_size = int(np.prod([self.shape[a] for a in batch_axes]))

    def _place(self, rank: int) -> None:
        self.data_index, self.model_index = divmod(rank, self.mp)
        rest, coords = rank, {}
        for name in reversed(self.axis_names):
            rest, coords[name] = divmod(rest, self.shape[name])
        self.coords = {k: coords[k] for k in self.axis_names}
        self.row_index = self.axis_index(self.row_axis)

    @property
    def leader(self) -> int:
        """Rank 0: it posts to the idle ranks."""
        return 0

    def axis_size(self, axis: str | None) -> int:
        """Ranks along ``axis`` (``"model"``, ``"data"`` — every data axis
        — or None, the grid)."""
        return {"model": self.mp, "data": self.dp, None: self.size}[axis]

    def axis_index(self, axis: str | None) -> int:
        """This rank's index along ``axis`` (as :meth:`axis_size`)."""
        self._member()
        return {"model": self.model_index, "data": self.data_index,
                None: self.rank}[axis]

    def axis_members(self, axis: str | None) -> tuple:
        """The grid ranks of this rank's group along ``axis``."""
        if axis == "model":
            lo = self.data_index * self.mp
            return tuple(range(lo, lo + self.mp))
        if axis == "data":
            return tuple(range(self.model_index, self.size, self.mp))
        return tuple(range(self.size))

    def link(self, axis: str | None) -> str:
        """``"nvlink"`` when this rank's group along ``axis`` lies in one
        node of ``RANKS_PER_NODE`` ranks (row-major), else
        ``"infiniband"``."""
        nodes = {r // RANKS_PER_NODE for r in self.axis_members(axis)}
        return "nvlink" if len(nodes) == 1 else "infiniband"

    def _member(self):
        if self.idle:
            raise RuntimeError(f"rank {self.rank} is idle: it is outside the "
                               f"{self.shape} grid")

    # -- placement --------------------------------------------------------
    def param_spec(self, shape: Sequence[int], axes) -> tuple:
        """The spec of a parameter on the grid: :func:`spec_for` under the
        grid's rules (the divisibility fallback included)."""
        return spec_for(shape, axes, self, self.rules)

    def local_shape(self, shape: Sequence[int], spec) -> tuple:
        """``shape`` with each dim ``spec`` claims divided by its axes'
        size."""
        out = list(shape)
        for i, part in enumerate(spec):
            if part is not None:
                out[i] //= self._span(part)[0]
        return tuple(out)

    def local_slice(self, shape: Sequence[int], spec) -> tuple:
        """This rank's block of ``shape`` under ``spec``: a slice per dim
        (the whole dim where ``spec`` claims none)."""
        self._member()
        out = [slice(None)] * len(shape)
        for i, part in enumerate(spec):
            if part is not None:
                n, idx = self._span(part)
                per = shape[i] // n
                out[i] = slice(idx * per, (idx + 1) * per)
        return tuple(out)

    def _span(self, part) -> tuple:
        """(size, this rank's row-major index) over the axes of a spec
        entry."""
        axes = part if isinstance(part, tuple) else (part,)
        n, idx = 1, 0
        for a in axes:
            n *= self.shape[a]
            idx = idx * self.shape[a] + self.coords.get(a, 0)
        return n, idx

    def rows_split(self, rows) -> bool:
        """Whether a batch of ``rows`` global rows is split over the batch
        axes (each rank holding its shard), rather than held whole by
        every rank: more than one rank on them, and they divide
        ``rows``."""
        return rows is not None and self.row_size > 1 \
            and rows % self.row_size == 0

    def local_rows(self, x, rows: int | None = None, *,
                   microbatches: int = 1):
        """This rank's rows of a global batch ``x`` (a tensor or array whose
        leading dim is the batch): its shard over the batch axes of each
        of ``microbatches`` slices when they divide a slice, else all of
        ``x``."""
        self._member()
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches")
        per = b // microbatches
        if not self.rows_split(per):
            return x
        r = per // self.row_size
        parts = [x[i * per + self.row_index * r:
                   i * per + (self.row_index + 1) * r]
                 for i in range(microbatches)]
        if len(parts) == 1:
            return parts[0]
        if isinstance(x, torch.Tensor):
            return torch.cat(parts)
        return np.concatenate(parts)

    # -- collectives ------------------------------------------------------
    def _report(self, kind: str, result: torch.Tensor, axis, nbytes_in):
        from repro_torch.kernels import accounting

        accounting.collective(
            kind, result.numel() * result.element_size(),
            self.axis_size(axis), "grid" if axis is None else axis,
            nbytes_in)

    def _comm(self, fn: str, tensor: torch.Tensor, axis, **kw) -> None:
        """The transport of a collective into ``tensor`` (in place):
        nothing on a traced grid."""

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum", *,
                   axis: str | None = "model"):
        """Reduces ``tensor`` in place over ``axis`` with ``op`` ("sum",
        "min", "max") and returns it."""
        self._member()
        if self.axis_size(axis) > 1:
            nbytes = tensor.numel() * tensor.element_size()
            self._report("all-reduce", tensor, axis, nbytes)
            self._comm("all_reduce", tensor, axis, op=op)
        return tensor

    def all_gather(self, x: torch.Tensor, dim: int = 0, *,
                   axis: str | None = "data") -> torch.Tensor:
        """The blocks of every rank along ``axis``, concatenated in order
        along ``dim`` (a new tensor; ``x`` itself on a one-rank axis)."""
        self._member()
        n = self.axis_size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        xm = x.movedim(dim, 0).contiguous()
        per = xm.shape[0]
        if self.backend == "nccl":
            buf = xm.new_empty((n * per, *xm.shape[1:]))
            self._report("all-gather", buf, axis, xm.numel()
                         * xm.element_size())
            self._comm("all_gather_into_tensor", buf, axis, src=xm)
        else:
            i = self.axis_index(axis)
            buf = xm.new_zeros((n * per, *xm.shape[1:]))
            buf[i * per:(i + 1) * per] = xm
            self._report("all-gather", buf, axis, xm.numel()
                         * xm.element_size())
            self._comm("all_reduce", buf, axis, op="sum")
        return buf.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0, *,
                       axis: str | None = "data") -> torch.Tensor:
        """``x`` summed over ``axis``, and this rank's block of the sum
        along ``dim`` (a new tensor)."""
        self._member()
        n = self.axis_size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        xm = x.movedim(dim, 0).contiguous()
        per = xm.shape[0] // n
        i = self.axis_index(axis)
        if self.backend == "nccl":
            out = xm.new_empty((per, *xm.shape[1:]))
            self._report("reduce-scatter", out, axis, xm.numel()
                         * xm.element_size())
            self._comm("reduce_scatter_tensor", out, axis, src=xm)
        else:
            full = xm.clone()
            out = xm.new_empty((per, *xm.shape[1:]))
            self._report("reduce-scatter", out, axis, xm.numel()
                         * xm.element_size())
            self._comm("all_reduce", full, axis, op="sum")
            out.copy_(full[i * per:(i + 1) * per])
            del full
        return out.movedim(0, dim)

    def gather_whole(self, block: torch.Tensor, spec) -> torch.Tensor:
        """A leaf whole from this rank's block of it under ``spec``: the
        blocks gathered along each claimed dim over its axes."""
        for dim, part in enumerate(spec):
            if part is not None:
                axes = part if isinstance(part, tuple) else (part,)
                block = self.all_gather(block, dim,
                                        axis=axis_key(self, axes))
        return block


class RankGrid(_WorldPost, _Grid):
    """The model path's ``(data, model)`` mesh across ``torch.distributed``
    ranks: the world's first ``prod(shape)`` ranks, row-major as
    ``jax.make_mesh`` lays out devices (rank = d·mp + r), with a leading
    ``"pod"`` axis where ``elastic_plan`` gives one, under the rule table
    of ``strategy`` (``"2d"``: FSDP × TP, ``"fsdp"``, ``"serve"``; see
    :class:`_Grid` for the layout and the collectives).

    Groups: one per data row (its ``mp`` ranks: the ``"model"`` axis) and
    one per model column (its ranks over the data axes: ``"data"``), made
    at construction by every world rank in the same order, as
    ``torch.distributed.new_group`` requires; one-rank axes make none.
    :meth:`survivors` gives the grid of a smaller plan on the world's
    first ranks; a rank past it is *idle* and stays in the world (it joins
    every group the survivors make and may wait for the leader's
    :meth:`post`).

    ``device`` is where the rank computes: ``cuda:{rank % device_count}``
    when None or ``"cuda"`` (which raises without a GPU), or what the
    caller passes.  The grid never picks the world's backend: gloo lets
    several ranks share one card, NCCL wants a card a rank.  A collective
    that fails raises.
    """

    def __init__(self, model_parallel: int = 1, *, device=None,
                 shape: Mapping[str, int] | None = None,
                 strategy: str = "2d", _groups=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("RankGrid needs an initialized process group "
                               "(torch.distributed.init_process_group)")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if shape is None:
            mp = model_parallel
            if isinstance(mp, bool) or not isinstance(mp, (int, np.integer)) \
                    or mp < 1 or self.world % mp:
                raise ValueError(f"model_parallel must be an int >= 1 that "
                                 f"divides the {self.world} ranks, got {mp!r}")
            shape = {"data": self.world // mp, "model": int(mp)}
        self._layout(shape, strategy)
        if self.size > self.world:
            raise ValueError(f"a {self.shape} grid needs {self.size} ranks, "
                             f"the world has {self.world}")
        if device is None or str(device) == "cuda":
            device = (f"cuda:{self.rank % torch.cuda.device_count()}"
                      if torch.cuda.is_available() else "cuda")
        self.device = resolve_device(device)
        self.backend = str(dist.get_backend())
        self._groups = {} if _groups is None else _groups
        rows = [tuple(range(i * self.mp, (i + 1) * self.mp))
                for i in range(self.dp)]
        cols = [tuple(range(r, self.size, self.mp)) for r in range(self.mp)]
        for members in rows + cols + [tuple(range(self.size))]:
            self._group(members)
        self.idle = self.rank >= self.size
        if self.idle:
            self.data_index = self.model_index = self.row_index = None
            self.coords = {}
            return
        self._place(self.rank)

    def _group(self, members: tuple):
        """The process group of ``members`` (None for one rank), made once
        for every grid that shares this one's groups."""
        if len(members) > 1 and members not in self._groups:
            self._groups[members] = (
                dist.group.WORLD if len(members) == self.world
                else dist.new_group(list(members), backend=self.backend))
        return self._groups.get(members)

    def _comm(self, fn: str, tensor: torch.Tensor, axis, *, op="sum",
              src=None) -> None:
        """The ``torch.distributed`` call, its dispatch hidden from the op
        counters (the collective reported itself)."""
        from repro_torch.kernels import accounting

        group = self._groups[self.axis_members(axis)]
        with accounting.paused():
            if fn == "all_reduce":
                dist.all_reduce(tensor, op=RankMesh._op(op), group=group)
            elif fn == "all_gather_into_tensor":
                dist.all_gather_into_tensor(tensor, src, group=group)
            else:
                dist.reduce_scatter_tensor(tensor, src, group=group)

    def survivors(self, plan) -> "RankGrid":
        """The grid of ``plan`` (a ``dist.fault.MeshPlan``: its shape and
        axis names) on the world's first ``plan.size`` ranks, the model
        axis and the strategy kept.  Every world rank must call it, idle
        ones included."""
        shape = dict(zip(plan.axis_names, plan.shape))
        if shape.get("model") != self.mp:
            raise ValueError(f"the plan {shape} must keep the model axis "
                             f"({self.mp})")
        return RankGrid(shape=shape, device=self.device,
                        strategy=self.strategy, _groups=self._groups)

    def __repr__(self) -> str:
        return (f"RankGrid(rank={self.rank}, world={self.world}, "
                f"shape={self.shape}, strategy={self.strategy}, "
                f"coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")


class TracedGrid(_Grid):
    """One rank of a grid with no process group, for the dry run: rank
    ``rank`` of a ``shape`` grid (``{"pod": 2, "data": 16, "model": 16}``,
    say) under ``strategy``, computing on the meta device.  Its layout is
    :class:`RankGrid`'s; its collectives move nothing — each returns a
    tensor of the right shape (uninitialised) and reports itself to the
    open op counters as :class:`RankGrid`'s do.  ``backend`` is the
    transport whose tensor work the trace carries: ``"nccl"`` (none, the
    production grid's) or ``"gloo"`` (the zero-padded gather, the
    all_reduce's copy), to hold a trace against a gloo world's."""

    idle = False

    def __init__(self, shape: Mapping[str, int], *, rank: int = 0,
                 strategy: str = "2d", backend: str = "nccl",
                 device="meta"):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
        self._layout(shape, strategy)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a {self.shape} grid")
        self.rank = rank
        self.world = self.size
        self.backend = backend
        self.device = torch.device(device)
        self._place(rank)

    def __repr__(self) -> str:
        return (f"TracedGrid(rank={self.rank}, shape={self.shape}, "
                f"strategy={self.strategy}, backend={self.backend})")


def rows_block_shape(shape, axes, grid) -> tuple:
    """The local shape on ``grid`` of a tensor of ``shape`` and logical
    ``axes`` whose BATCH dim holds the rank's rows already (a cache): its
    spec with the BATCH dim left out, applied; ``shape`` off a grid."""
    if grid is None:
        return tuple(shape)
    axes = tuple(None if a == BATCH else a for a in axes)
    return grid.local_shape(shape, grid.param_spec(shape, axes))


def grid_of(mesh) -> "_Grid | None":
    """``mesh`` if it is a grid of ranks (real or traced), else None."""
    return mesh if isinstance(mesh, _Grid) else None


def active_grid() -> "_Grid | None":
    """The grid of the innermost ``activation_sharding`` context, or
    None."""
    ctx = active_context()
    return None if ctx is None else grid_of(ctx[0])


def rows_share(local_rows: int) -> float:
    """The share of the global batch's rows that ``local_rows`` are: the
    rank's rows over the active context's ``batch`` under a grid that
    splits them, else 1.  A mean over the rank's tokens times it is the
    rank's part of the global batch's mean."""
    grid = active_grid()
    rows = active_batch()
    if grid is None or not grid.rows_split(rows):
        return 1.0
    return local_rows / rows


def rows_partial() -> bool:
    """Whether the active grid splits the batch's rows: a rank's loss is
    then a part of the global one, and so is each gradient it takes."""
    grid = active_grid()
    return grid is not None and grid.rows_split(active_batch())


# --------------------------------------------------------------------------
# the grid's autograd Functions
# --------------------------------------------------------------------------
class _SumForward(torch.autograd.Function):
    """SUM over a grid axis forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        out = x.contiguous().clone()
        return grid.all_reduce(out, "sum", axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, SUM over a grid axis backward."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        return ctx.grid.all_reduce(out, "sum", axis=ctx.axis), None, None


def copy_to(x, grid, axis: str = "model"):
    """Megatron's "f": ``x`` as is, its gradient summed over ``axis``
    (each rank of the axis computed a part of it)."""
    if grid is None or grid.axis_size(axis) == 1:
        return x
    return _SumBackward.apply(x, grid, axis)


def reduce_from(x, grid, axis: str = "model"):
    """Megatron's "g": ``x`` summed over ``axis``, its gradient passed on
    as is (every rank of the axis holds the whole sum, and each uses it
    alike).  Not ``torch.distributed.nn.functional.all_reduce``, whose
    backward sums again."""
    if grid is None or grid.axis_size(axis) == 1:
        return x
    return _SumForward.apply(x, grid, axis)


def copy_to_model(x, grid):
    return copy_to(x, grid, "model")


def reduce_from_model(x, grid):
    return reduce_from(x, grid, "model")


class _Gather(torch.autograd.Function):
    """The blocks of ``axis`` gathered along ``dim`` forward; backward,
    the gradient reduce-scattered (``partial``: each rank's use of the
    whole was a part of the loss's) or this rank's block of it (every rank
    used the whole alike)."""

    @staticmethod
    def forward(ctx, x, grid, axis, dim, partial):
        ctx.grid, ctx.axis, ctx.dim, ctx.partial = grid, axis, dim, partial
        ctx.per = x.shape[dim]
        return grid.all_gather(x, dim, axis=axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            out = ctx.grid.reduce_scatter(g, ctx.dim, axis=ctx.axis)
        else:
            lo = ctx.grid.axis_index(ctx.axis) * ctx.per
            out = g.narrow(ctx.dim, lo, ctx.per).contiguous()
        return out, None, None, None, None


class _TakeBlock(torch.autograd.Function):
    """Block i of n of dim 0 (i: this rank's index on the axis) forward;
    backward, the ranks' gradients gathered, so every rank holds the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        n, i = grid.axis_size(axis), grid.axis_index(axis)
        per = x.shape[0] // n
        ctx.grid, ctx.axis = grid, axis
        return x[i * per:(i + 1) * per].clone()

    @staticmethod
    def backward(ctx, g):
        return (ctx.grid.all_gather(g.contiguous(), 0, axis=ctx.axis),
                None, None)


def gather(x, grid, axis: str | None = "data", dim: int = 0, *,
           partial: bool = False):
    """The ranks' blocks of ``x`` along ``dim`` over ``axis``, whole; the
    gradient comes back reduce-scattered when ``partial``, else as this
    rank's block (see :class:`_Gather`)."""
    if grid is None or grid.axis_size(axis) == 1:
        return x
    return _Gather.apply(x, grid, axis, dim % x.dim(), partial)


def take_block(x, grid, axis: str = "data"):
    """This rank's block of dim 0 over ``axis``; the gradient comes back
    whole on every rank."""
    if grid.axis_size(axis) == 1:
        return x
    return _TakeBlock.apply(x, grid, axis)


def gather_blocks(x, grid, axis: str = "data"):
    """The ranks' blocks of dim 0 over ``axis``, concatenated in order; the
    gradient of this rank's block comes back."""
    return gather(x, grid, axis, 0)


def gather_leaf(w, spec, axes, grid, *, partial: bool | None = None):
    """A parameter block ``w`` (its ``spec`` and logical ``axes``) as a
    rank uses it: gathered along every dim placed on an axis the batch's
    rows split over (FSDP; VOCAB under ``"fsdp"``), so that only its
    tensor-parallel dims (on ``model``) and the experts' dim stay blocks.
    ``partial`` (default: whether the active grid splits the rows) makes
    the gradient come back reduce-scattered."""
    if partial is None:
        partial = rows_partial()
    rows = set(_mesh_axes_for(grid.rules, BATCH))
    for dim, (part, name) in enumerate(zip(spec, axes)):
        if part is None or name == EXPERT:
            continue
        mesh_axes = part if isinstance(part, tuple) else (part,)
        if not set(mesh_axes) & rows:
            continue
        w = gather(w, grid, axis_key(grid, mesh_axes), dim, partial=partial)
    return w


def fit_block(w, grid, dim: int, ranges, full: int, *, partial: bool):
    """The ranges ``[(lo, hi), …]`` of a leaf's ``dim`` (``full`` long),
    concatenated, from ``w``: the whole dim, or this rank's block of it on
    ``model``.  A block that is not what is asked for is gathered over
    ``model`` first; ``partial``: the ranks use different ranges, so a
    whole leaf's gradient is summed over ``model`` and a gathered one's
    reduce-scattered."""
    dim = dim % w.dim()
    n = w.shape[dim]
    if n != full:
        per = full // grid.mp
        if n != per:
            raise ValueError(f"a block of {n} of a dim of {full} on a "
                             f"model axis of {grid.mp}")
        lo = grid.model_index * per
        if list(ranges) == [(lo, lo + per)]:
            return w
        w = gather(w, grid, "model", dim, partial=partial)
    elif partial:
        w = copy_to(w, grid, "model")
    if list(ranges) == [(0, full)]:
        return w
    return torch.cat([w.narrow(dim, lo, hi - lo) for lo, hi in ranges],
                     dim=dim)
