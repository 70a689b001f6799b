"""Op accounting of an eager step: dot FLOPs, dot bytes, bytes accessed,
collective wire bytes, kernel launches and the peak of live storage
bytes.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
JAX's dry run parses the optimized HLO of a compiled step; eager PyTorch
emits no HLO, so the step is run once — on the ``meta`` device, where
nothing is computed or allocated — under :class:`OpCounter`, a
``TorchDispatchMode`` that sees every aten op after autograd and
decomposition.  The counter only records a trace of events; :func:`analyze`
turns a trace into :class:`OpStats`, so a saved trace can be re-analysed
under changed rules (``launch/reanalyze.py``).  The rules, as
``hlo_analysis`` counts:

* dots — ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``,
  ``dot``: 2 × |result| × |contraction| FLOPs; bytes are the two operands
  plus the result (a bias is elementwise work and is not counted);
* bytes accessed — the counterpart of XLA's ``cost_analysis`` "bytes
  accessed": every op's tensor arguments read and its outputs written,
  each once (an argument broadcast by a stride of 0 at most its storage),
  on the counter's device; a view and an allocation without a write
  (``empty``) move nothing; an in-place op that only writes its target
  (``fill_``, ``zero_``, ``copy_``) does not read it.  Eager PyTorch fuses
  nothing, so every op's traffic is its own;
* ``convolution``: 2 × |result| × (input channels per group × window),
  kept apart as ``conv_flops``;
* collectives: per-device wire bytes under ring algorithms
  (:func:`wire_bytes`, the formulas of ``hlo_analysis._wire_bytes``), by
  kind and by grid axis — c10d functional collectives, and those a grid
  of ranks reports through ``kernels/accounting.collective`` (the kind
  NCCL runs, the result's bytes, the group's size and the axis); 0 on one
  card;
* kernel launches: the kernel wrappers report each launch through
  ``kernels/accounting.launch``.  A launch counts the dot FLOPs of the
  kernel's plain version on the same shapes (traced on ``meta``), so a
  trace through the kernels and one through the plain versions count the
  same dot FLOPs; its bytes — dot bytes and bytes accessed alike — are the
  kernel's own HBM traffic, its inputs read and its outputs written once,
  since it keeps its intermediates (attention's scores, the SSD's L×L
  products) on chip;
* live bytes: a storage an op creates counts from its creation until it is
  freed, rounded up to the CUDA caching allocator's 512-byte blocks; a
  storage the step was handed and frees during the trace counts
  negatively; a 0-d tensor first seen as an input (a scalar constant
  ``torch.tensor`` made, a host scalar on the card) does not count; an op
  in :data:`CARD_TEMPS` adds the temporary its CUDA kernel allocates for
  the op's duration.  ``peak_bytes`` is the largest running sum: the
  step's peak allocation above what it was handed.

Eager execution runs every layer, so nothing is counted once and scaled,
except a loop that announces itself through ``kernels/accounting.trips``
(the train step's microbatch loop): under counters on the meta device it
runs two iterations, the second weighing the trip count less one, as
``hlo_analysis`` multiplies a while body by its trip count.  Live bytes
are not weighted: the iterations run one after another, and the second
holds the first's results as every later one holds its predecessor's.  A
counter on real tensors never samples, so it never changes what a step
computes.
"""
from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import math
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import accounting

#: The CUDA caching allocator's block granularity.
ALLOC_ROUND = 512

_DOTS = {  # op → index of the operand whose last dim is contracted
    "mm": 0, "bmm": 0, "mv": 0, "addmm": 1, "baddbmm": 1, "addmv": 1,
    "dot": 0, "vdot": 0,
}
#: Ops whose CUDA kernel allocates a temporary of its output's size through
#: the caching allocator, below the dispatcher (measured on the H100: the
#: peak of softmax's backward over |grad_input| is 2 × |grad_input|); the
#: trace counts it for the op's duration.
CARD_TEMPS = frozenset({"_softmax_backward_data"})
#: Ops that move no bytes besides views: allocations without a write.
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "_unsafe_view", "resize_",
                         "set_"})
#: In-place ops that write their target without reading it.
_WRITE_ONLY = frozenset({"fill_", "zero_", "copy_"})
_COLLECTIVES = {  # c10d functional op → (kind, index of its group size)
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_out": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return 0 if n <= 0 else -(-n // ALLOC_ROUND) * ALLOC_ROUND


def wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` over ``g``
    ranks under ring algorithms (``hlo_analysis._wire_bytes``)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


@dataclasses.dataclass
class OpStats:
    """What a trace adds up to (``hlo_analysis.HloStats``'s fields that
    carry over, and the eager step's own)."""

    dot_flops: float = 0.0
    conv_flops: float = 0.0
    dot_bytes: float = 0.0  # operands + result of every dot
    bytes_accessed: float = 0.0  # every op's arguments + outputs
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)
    collective_by_axis: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    kernel_dot_flops: float = 0.0  # the part of dot_flops launches carry
    # the part of dot_flops in the plain forwards a kernel's backward
    # recomputes (kernels/flash_attention.py::plain_grads)
    kernel_recompute_dot_flops: float = 0.0
    peak_bytes: int = 0  # peak live bytes above the start
    end_bytes: int = 0  # live bytes at the end (the outputs)
    op_count: int = 0
    loop_trips: list = dataclasses.field(default_factory=list)

    @property
    def flops(self) -> float:
        return self.dot_flops + self.conv_flops


def analyze(trace: list, *, world: int = 1) -> OpStats:
    """:class:`OpStats` of a trace (an :class:`OpCounter`'s ``trace``, or
    one read back by :func:`load_trace`); ``world`` is the group size of a
    collective that names none."""
    st = OpStats()
    live = 0
    depth = 0  # inside a kernel backward's recomputed forward
    for ev in trace:
        kind = ev[0]
        if kind == "alloc":
            live += ev[2]
            st.peak_bytes = max(st.peak_bytes, live)
        elif kind == "free":
            live -= ev[2]
        elif kind == "op":
            _, _, acc, w = ev
            st.op_count += w
            st.bytes_accessed += float(acc) * w
        elif kind == "dot":
            _, _, out_numel, contract, lhs, rhs, out, acc, w = ev
            st.op_count += w
            st.bytes_accessed += float(acc) * w
            st.dot_flops += 2.0 * out_numel * contract * w
            st.dot_bytes += float(lhs + rhs + out) * w
            if depth:
                st.kernel_recompute_dot_flops += 2.0 * out_numel * contract * w
        elif kind == "conv":
            _, _, out_numel, window, acc, w = ev
            st.op_count += w
            st.bytes_accessed += float(acc) * w
            st.conv_flops += 2.0 * out_numel * window * w
        elif kind == "collective":
            _, ckind, result, g, acc, w, *axis = ev
            st.op_count += w
            st.bytes_accessed += float(acc) * w
            wire = wire_bytes(ckind, result, world if g is None else g) * w
            st.collective_bytes += wire
            st.collective_by_kind[ckind] = (
                st.collective_by_kind.get(ckind, 0.0) + wire)
            ax = axis[0] if axis else "world"
            st.collective_by_axis[ax] = (
                st.collective_by_axis.get(ax, 0.0) + wire)
            st.collective_count += w
        elif kind == "launch":
            _, name, flops, nbytes, w = ev
            st.kernel_launches[name] = st.kernel_launches.get(name, 0) + w
            st.kernel_dot_flops += flops * w
            st.dot_flops += flops * w
            st.dot_bytes += nbytes * w
            st.bytes_accessed += nbytes * w
        elif kind == "loop":
            st.loop_trips.append(ev[1])
        elif kind == "recompute":
            depth += ev[1]
        else:
            raise ValueError(f"unknown trace event {ev!r}")
    st.end_bytes = live
    return st


class OpCounter(TorchDispatchMode):
    """Records the trace of the ops run inside it (see the module note).

    Live bytes and bytes accessed are those of storages on ``device`` (a
    device type; the host's temporaries, such as the CPU scalar
    ``torch.tensor`` makes before copying it, stay out of a meta or CUDA
    trace).  On ``"meta"`` it samples a loop announced by
    ``accounting.trips``.  ``stats(world=)`` is :func:`analyze` of the
    trace so far.  It is one of ``kernels/accounting``'s counters."""

    def __init__(self, *, device: str = "meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.trace: list = []
        self.weight = 1
        self.paused = 0
        self._ids: dict = {}  # live storage (its _cdata) → id, None ignored
        self._finalizers: list = []
        self._next_id = 0
        self._open = False

    def stats(self, *, world: int = 1) -> OpStats:
        return analyze(self.trace, world=world)

    def note(self, event: list) -> None:
        self.trace.append(event)

    def planned_launch(self, name: str, io_bytes: int, plain, args,
                       kwargs) -> None:
        """One launch of kernel ``name``: the dot FLOPs of
        ``plain(*args, **kwargs)``, the kernel's own ``io_bytes``."""
        key = tuple(("tensor", tuple(a.shape), a.dtype)
                    if isinstance(a, torch.Tensor) else a for a in args)
        flops = _plain_flops(plain, key, tuple(sorted(kwargs.items())))
        self.trace.append(["launch", name, flops, io_bytes, self.weight])

    def __enter__(self):
        accounting.counters().append(self)
        self._open = True
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._open = False
            accounting.counters().remove(self)
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()
            self._ids.clear()

    # -- storages ---------------------------------------------------------
    def _see(self, t: torch.Tensor, *, new: bool,
             ignore: bool = False) -> None:
        if t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._ids:
            return
        nbytes = _rounded(st.nbytes())
        sid = None if ignore else self._next_id
        self._next_id += not ignore
        self._ids[key] = sid
        if new and not ignore:
            self.trace.append(["alloc", sid, nbytes])
        f = weakref.finalize(st, self._freed, key, sid, nbytes)
        f.atexit = False
        self._finalizers.append(f)

    def _freed(self, key, sid, nbytes) -> None:
        if self._open:
            if sid is not None:
                self.trace.append(["free", sid, nbytes])
            self._ids.pop(key, None)

    # -- ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        # an input first seen here was handed to the step, or is a
        # constant torch.tensor made: lifted into the trace (new) on the
        # CPU and the card, unseen until used on meta.  0-d ones — scalar
        # constants, host scalars on the card — are not counted.
        lifted = func.overloadpacket.__name__.startswith("lift_fresh")
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._see(t, new=lifted, ignore=t.dim() == 0)
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self.trace.append(self._event(func, args, out,
                                      self._accessed(func, ins, outs)))
        for t in outs:
            self._see(t, new=True)
        if func.overloadpacket.__name__ in CARD_TEMPS:
            nbytes = _rounded(_nbytes(out))
            self.trace += [["alloc", -1, nbytes], ["free", -1, nbytes]]
        return out

    def _accessed(self, func, ins: list, outs: list) -> int:
        """Bytes the op reads of its tensor arguments ``ins`` and writes
        of its outputs ``outs`` on the counter's device (see the module
        note)."""
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return 0
        if name in _WRITE_ONLY:
            ins = ins[1:]  # the target, the op's first argument
        read = sum(min(_nbytes(t), t.untyped_storage().nbytes())
                   for t in ins if t.device.type == self.device)
        return read + sum(_nbytes(t) for t in outs
                          if t.device.type == self.device)

    def _event(self, func, args, out, acc) -> list:
        name = func.overloadpacket.__name__
        w = self.weight
        if func.namespace == "aten" and name in _DOTS:
            lhs, rhs = args[_DOTS[name]], args[_DOTS[name] + 1]
            return ["dot", name, out.numel(), lhs.shape[-1], _nbytes(lhs),
                    _nbytes(rhs), _nbytes(out), acc, w]
        if func.namespace == "aten" and name == "convolution":
            # weight (C_out, C_in / groups, k…), or (C_in, C_out / groups,
            # k…) transposed: each output (each input, transposed) takes
            # prod(weight.shape[1:]) multiply-adds
            per = math.prod(args[1].shape[1:])
            src = args[0] if args[6] else out
            return ["conv", name, src.numel(), per, acc, w]
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind, gi = _COLLECTIVES[name]
            g = None if gi is None else int(args[gi])
            res = out if isinstance(out, torch.Tensor) else args[0]
            return ["collective", kind, _nbytes(res), g, acc, w]
        return ["op", name, acc, w]


@functools.lru_cache(maxsize=512)
def _plain_flops(plain, key, kwargs) -> float:
    """Dot FLOPs of ``plain`` on meta tensors of the shapes and dtypes in
    ``key``, counted while every open counter pauses."""
    counters = list(accounting.counters())
    for c in counters:
        c.paused += 1
    try:
        args = [torch.empty(a[1], dtype=a[2], device="meta")
                if isinstance(a, tuple) and a[:1] == ("tensor",) else a
                for a in key]
        with torch.no_grad(), OpCounter() as inner:
            plain(*args, **dict(kwargs))
        st = inner.stats()
    finally:
        for c in counters:
            c.paused -= 1
    return st.dot_flops


def save_trace(path, trace: list) -> None:
    """Writes a trace as gzipped JSON."""
    with gzip.open(path, "wt") as f:
        json.dump(trace, f, separators=(",", ":"))


def load_trace(path) -> list:
    with gzip.open(path, "rt") as f:
        return json.load(f)
