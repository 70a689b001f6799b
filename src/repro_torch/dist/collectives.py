"""Compressed synchronization (inter-iteration), as in the JAX package's
``dist/collectives.py``.

A summed tensor is quantized to int8 (or int4) with one per-tensor scale
before the reduce, and the rounding error is *fed back* — added to the next
round's tensor — so no mass is lost, only delayed (EF-SGD).

Two implementations share the math:

* ``compressed_allreduce_ref`` — a host loop over per-device tensors, the
  oracle for tests and for reasoning about error bounds;
* ``make_compressed_allreduce`` — the reduce over a stacked device axis.
  On one card the axis is the port's m logical devices
  (``plug.protocols.divisor_mesh``): a leaf of shape (m·k, …) holds
  device g's slice at rows g·k … (g+1)·k − 1, as a ``shard_map`` over a
  mesh axis of m devices would see it.  Across ranks
  (``dist.sharding.RankMesh``, m = W·local) a rank's leaf holds its
  ``local`` devices' slices, and the axis' reductions are collectives:
  the shared scale an ``all_reduce`` MAX, the int codes an int32
  ``all_reduce`` SUM (the JAX package's scale ``all_gather`` and
  ``psum``); the residual stays with its rank.  Two wire formats:

  - ``wire="int8"`` (the default, the real wire): every slice quantizes
    with its local scale, the scales are shared (4 bytes a device), the
    largest re-quantizes every payload, and the sum over the axis
    accumulates in int32 — exact — before one dequantize.
  - ``wire="emulated"``: each slice dequantizes with its own scale before
    a float32 sum over the axis (the wire would carry float32; only the
    accounting counts ``bits``).

Every float32 operation runs in the JAX package's order, and
``torch.round`` rounds half to even as ``jnp.round`` does, so the results
equal the JAX package's.  Divisions by an integer (qmax, the device count)
divide by a tensor on the operands' device: PyTorch's CUDA division by a
Python scalar multiplies by its reciprocal, which is not the IEEE quotient.
Wire accounting uses ``collective_bytes_saved``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.dist.sharding import LOCAL_MESH, RankMesh

_EPS = 1e-12
WIRE_FORMATS = ("int8", "emulated")


def _div(x, n):
    """``x / n`` as an IEEE float32 quotient on any device."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def _qmax(bits: int) -> int:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return (1 << (bits - 1)) - 1


# --------------------------------------------------------------------------
# symmetric per-tensor int quantization
# --------------------------------------------------------------------------
def quantize_int(x, bits: int = 8):
    """(q, scale): symmetric round-to-nearest onto ``bits``-bit integers.

    ``q`` is held in int8 for any ``bits`` ≤ 8 (int4 values lie in
    [-7, 7]); ``scale`` is a float32 scalar tensor with ``|dequant − x| ≤
    scale/2`` elementwise.  An all-zero input quantizes to zeros (the scale
    floors at eps)."""
    qmax = _qmax(bits)
    xf = x.to(torch.float32)
    scale = _div(xf.abs().amax().clamp_min(_EPS), qmax)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_int(q, scale):
    return q.to(torch.float32) * scale


quantize_int8 = functools.partial(quantize_int, bits=8)
quantize_int4 = functools.partial(quantize_int, bits=4)
dequantize_int8 = dequantize_int
dequantize_int4 = dequantize_int


# --------------------------------------------------------------------------
# error-feedback all-reduce
# --------------------------------------------------------------------------
def _round(x, residual, bits: int):
    """One device's half of the EF round: returns (sent, new_residual)."""
    t = x + residual
    q, s = quantize_int(t, bits)
    sent = dequantize_int(q, s)
    return sent, t - sent


def _fold_sum(slices):
    """Sum over the device axis in device order (a psum's order)."""
    return functools.reduce(torch.add, slices)


def compressed_allreduce_ref(locals_, residuals, *, bits: int = 8):
    """Host-loop reference over per-device lists.

    Each device sends ``quantize(local + residual)`` and keeps the rounding
    remainder as its next residual; every device receives the mean of the
    dequantized payloads.  Returns ``(means, new_residuals)``: one
    (identical) mean per device."""
    if len(locals_) != len(residuals):
        raise ValueError("one residual per shard required")
    sents, new_res = [], []
    for x, r in zip(locals_, residuals):
        sent, nr = _round(x, r, bits)
        sents.append(sent)
        new_res.append(nr)
    mean = _div(_fold_sum(sents), len(sents))
    return [mean for _ in sents], new_res


def _int_wire_round(t, size: int, bits: int, axis):
    """The real int wire round over a (local, …) stack of this process's
    device slices of an axis of ``size`` devices, over ``axis`` (a
    ``RankMesh``, or ``LOCAL_MESH`` when local == size).

    Each slice's local scale is ``max(amax, eps)/qmax``; the shared scale
    is the largest (the scale all-gather: the local slices', then an
    ``all_reduce`` MAX over the ranks); every slice re-quantizes against
    it; the sum over the axis accumulates in int32 — exact — (the local
    slices, then an int32 ``all_reduce`` SUM); one dequantize.  Returns
    ``(mean (…), new_residual (local, …))``: the residual is what the
    shared-scale grid dropped."""
    qmax = _qmax(bits)
    tf = t.to(torch.float32)
    amax = tf.reshape(tf.shape[0], -1).abs().amax(dim=1)
    local = _div(amax.clamp_min(_EPS), qmax)
    shared = axis.all_reduce(local.amax().reshape(1), "max")[0]
    q = torch.clamp(torch.round(tf / shared), -qmax, qmax).to(torch.int8)
    sent = q.to(torch.float32) * shared
    acc = axis.all_reduce(q.to(torch.int32).sum(dim=0, dtype=torch.int32),
                          "sum")  # exact
    mean = _div(acc.to(torch.float32) * shared, size)
    return mean, t - sent


def _emulated_round(xs, rs, size: int, bits: int, axis):
    """The emulated round: each slice dequantizes with its own scale, and
    the m payloads add in device order.  Each process writes its payloads
    into its rows of an (m, …) zero stack that one ``all_reduce`` SUM over
    ``axis`` fills (each element has one non-zero addend, so the sum is
    exact), and every process then adds in device order."""
    rounds = [_round(xi, ri, bits) for xi, ri in zip(xs.unbind(0),
                                                     rs.unbind(0))]
    sents = torch.stack([s for s, _ in rounds])
    full = sents.new_zeros((size, *sents.shape[1:]))
    lo = axis.rank * len(rounds)
    full[lo:lo + len(rounds)] = sents
    full = axis.all_reduce(full, "sum")
    mean = _div(_fold_sum(full.unbind(0)), size)
    return mean, torch.stack([n for _, n in rounds])


def make_compressed_allreduce(mesh, axis_name: str = "shard", *,
                              bits: int = 8, wire: str = "int8"):
    """The EF all-reduce over a stacked axis of m devices.

    ``mesh`` is m, the port's logical devices on one card (an int, as
    ``plug.protocols.divisor_mesh`` gives it), or a
    :class:`~repro_torch.dist.sharding.RankMesh` of W ranks holding
    ``local`` devices each (m = W·local); ``axis_name`` names the axis in
    errors.  The returned function takes ``(tree, residual_tree)`` — a
    tensor or a dict of tensors whose leading dim (local·k) holds this
    process's device slices (local = m on one process) — and returns
    ``(mean_tree, new_residual_tree)`` of the same shapes: each device's
    slice of the mean is the mean of the m slices.  ``wire="int8"`` runs
    the real integer wire; ``wire="emulated"`` the dequantize-then-sum
    round with per-device scales that ``compressed_allreduce_ref``
    oracles.  Over a RankMesh every rank must call it with leaves of the
    same shapes, in the same order."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    _qmax(bits)
    if isinstance(mesh, RankMesh):
        axis, size, local = mesh, mesh.size, mesh.local
    elif isinstance(mesh, bool) or not isinstance(mesh, int) or mesh < 1:
        raise ValueError(f"mesh must be an int m >= 1 of logical devices "
                         f"or a RankMesh, got {mesh!r}")
    else:
        axis, size, local = LOCAL_MESH, mesh, mesh

    def one(x, r):
        if x.shape != r.shape:
            raise ValueError(f"residual {tuple(r.shape)} does not match "
                             f"{tuple(x.shape)}")
        if x.dim() == 0 or x.shape[0] % local:
            raise ValueError(f"leading dim of {tuple(x.shape)} must split "
                             f"into {axis_name}={local} device slices")
        xs = x.reshape(local, x.shape[0] // local, *x.shape[1:])
        rs = r.reshape(xs.shape)
        if wire == "int8":
            mean, nr = _int_wire_round(xs + rs, size, bits, axis)
        else:
            mean, nr = _emulated_round(xs, rs, size, bits, axis)
        means = mean.unsqueeze(0).expand(xs.shape).reshape(x.shape)
        return means, nr.reshape(x.shape)

    def allreduce(xs, residuals):
        if isinstance(xs, dict):
            if set(xs) != set(residuals):
                raise ValueError("residuals must have the tree's keys")
            # one key order on every rank: the collectives pair up
            out = {k: one(xs[k], residuals[k]) for k in sorted(xs)}
            return ({k: out[k][0] for k in xs},
                    {k: out[k][1] for k in xs})
        return one(xs, residuals)

    return allreduce


def collective_bytes_saved(wire_bytes: int, *, bits: int = 8,
                           baseline_bits: int = 16) -> int:
    """Wire bytes saved by a ``bits``-bit payload against the bf16
    baseline: int8 halves the volume, ``collective_bytes_saved(1000) ==
    500``.  The per-tensor scale (4 bytes) is ignored."""
    return wire_bytes - (wire_bytes * bits) // baseline_bits
