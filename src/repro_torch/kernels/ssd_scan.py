"""Mamba2 SSD within-chunk step: the wrapper over ``csrc/ssd_scan.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_chunk_pallas``.
The wrapper checks device, dtype, shape and contiguity; on CPU tensors it
runs :func:`ssd_chunk_plain`, on CUDA tensors it launches the kernel or
raises — there is no fallback.  It counts its launches in
``ssd_chunk.launches``.  The kernel's bound and design are in the note at
the top of the ``.cu`` file; its times on the card are in PERF.md.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import accounting, build, ref
from repro_torch.kernels.flash_attention import plain_grads

#: Head dims P the CUDA kernel is compiled for (``csrc/ssd_scan.cu``).
HEAD_DIMS = (16, 32, 64, 128)


def _check(x, dt, a, b_mat, c_mat):
    """Shapes, dtype (float32), device and contiguity; returns
    (B, NC, L, H, P, G, N)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, NC, L, H, P), got {tuple(x.shape)}")
    bsz, nc, l, h, p = x.shape
    if b_mat.dim() != 5:
        raise ValueError(f"b_mat must be (B, NC, L, G, N), got "
                         f"{tuple(b_mat.shape)}")
    g, n = b_mat.shape[3], b_mat.shape[4]
    if g < 1 or h % g != 0:
        raise ValueError(f"H={h} must be a multiple of G={g}")
    want = {"x": (bsz, nc, l, h, p), "dt": (bsz, nc, l, h), "a": (h,),
            "b_mat": (bsz, nc, l, g, n), "c_mat": (bsz, nc, l, g, n)}
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_mat", b_mat),
                    ("c_mat", c_mat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return bsz, nc, l, h, p, g, n


def ssd_chunk_plain(x, dt, a, b_mat, c_mat):
    """Plain version of :func:`ssd_chunk`: ``ref.ssd_chunk_local`` over all
    chunks at once (chunks folded into the batch, B and C expanded to the
    heads), plus the carry gate ``exp(cumsum(a·dt))``."""
    bsz, nc, l, h, p = x.shape
    n = b_mat.shape[4]

    def fold(t):
        return t.reshape(bsz * nc, *t.shape[2:])

    y, state, decay = ref.ssd_chunk_local(
        fold(x), fold(dt), a, fold(ref.expand_groups(b_mat, h)),
        fold(ref.expand_groups(c_mat, h)))
    gate = torch.exp(torch.cumsum(a[None, None, :] * fold(dt), dim=1))
    return (y.reshape(bsz, nc, l, h, p), state.reshape(bsz, nc, h, n, p),
            decay.reshape(bsz, nc, h), gate.reshape(bsz, nc, l, h))


def ssd_chunk(x, dt, a, b_mat, c_mat):
    """Within-chunk SSD over all (batch, chunk, head) cells.

    Args (all float32, contiguous, on one device):
      x (B, NC, L, H, P), dt (B, NC, L, H), a (H,),
      b_mat/c_mat (B, NC, L, G, N) with H % G == 0 — head ``h`` reads group
      ``h // (H // G)``; G == H is the JAX kernel's heads-expanded layout.
    Returns: y (B, NC, L, H, P), state (B, NC, H, N, P), decay (B, NC, H),
    carry gate (B, NC, L, H), all float32.  On the card one call is one
    launch of ``csrc/ssd_scan.cu``, whose y CTAs and state CTAs run side by
    side.  Its shared memory grows with L and P, not N (L=256 uses 108 KiB
    at P=64, 140 KiB at P=128); a chunk that does not fit the card's
    227 KiB (L > 704 at P=64) is refused by the C entry, as a RuntimeError,
    before anything launches.  Views that do not start on 16 bytes, and N
    not a multiple of 4, are read one float at a time.  Under autograd,
    with an input that requires grad, the launch goes through an
    ``autograd.Function`` whose backward differentiates
    :func:`ssd_chunk_plain` on the saved inputs; on CPU tensors the plain
    version differentiates as it is.  Meta tensors take the CUDA branch,
    checks and ``autograd.Function`` included, with a planned launch.
    """
    bsz, nc, l, h, p, g, n = _check(x, dt, a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, a, b_mat, c_mat)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunk runs on cuda or cpu (meta for a dry "
                         f"run), got {x.device}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk's CUDA kernel takes head dims "
                         f"P in {HEAD_DIMS}, got P={p}")
    if l < 1 or n < 1:
        raise ValueError(f"ssd_chunk's CUDA kernel needs L >= 1 and N >= 1; "
                         f"got L={l}, N={n}")
    inputs = (x, dt, a, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SSDChunk.apply(*inputs)
    return _launch(*inputs)


def _launch(x, dt, a, b_mat, c_mat):
    """One launch of the CUDA kernel; counts it.  On meta tensors (a dry
    run) the launch is planned, not made: the outputs are allocated and
    the launch reported to the active op counters (``accounting.launch``),
    without the library or the count."""
    bsz, nc, l, h, p = x.shape
    g, n = b_mat.shape[3], b_mat.shape[4]
    dev = x.device
    y = torch.empty((bsz, nc, l, h, p), dtype=torch.float32, device=dev)
    state = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=dev)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=dev)
    gate = torch.empty((bsz, nc, l, h), dtype=torch.float32, device=dev)
    if bsz * nc * h == 0:
        return y, state, decay, gate
    accounting.launch("ssd_chunk", (y, state, decay, gate), ssd_chunk_plain,
                      x, dt, a, b_mat, c_mat)
    if dev.type == "meta":
        return y, state, decay, gate
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gx_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), y.data_ptr(), state.data_ptr(),
            decay.data_ptr(), gate.data_ptr(), bsz, nc, l, h, p, g, n,
            stream)
    build.check(rc, "gx_ssd_chunk")
    ssd_chunk.launches += 1
    return y, state, decay, gate


class _SSDChunk(torch.autograd.Function):
    """The kernel's forward with a gradient; the backward differentiates
    :func:`ssd_chunk_plain` on the saved inputs (plain autograd's
    gradients on the same inputs)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return plain_grads(ssd_chunk_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, grads)


ssd_chunk.launches = 0
