"""Flash attention (forward): the wrapper over the CUDA kernels and their
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_pallas``.  Each dtype has one kernel: bfloat16 the Hopper
kernel of ``csrc/flash_attention_sm90.cu`` (wgmma and a TMA ring), float32
the kernel of ``csrc/flash_attention.cu`` (3xTF32 on ``mma.sync``: each
product as three TF32 tensor-core products, float32 accuracy).  The
wrapper checks device, dtype, shape and contiguity; on CPU tensors it runs
:func:`flash_attention_plain`, on CUDA tensors it launches the kernel or
raises — there is no fallback.  It counts its launches in
``flash_attention.launches``.  The kernels' bounds and designs are in the
notes at the top of the ``.cu`` files; their times on the card are in
PERF.md.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import accounting, build

#: Head dims both CUDA kernels take: multiples of 8 up to 128, as the JAX
#: kernel's (8, 128) tiling allows.  Each runs an instantiation at a head dim
#: D >= d whose extra columns are zeros (csrc/flash_attention*.cu).
HEAD_DIMS = tuple(range(8, 129, 8))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    """Shapes (Hq a multiple of Hkv, as the JAX package asks), dtype,
    device and contiguity; returns (b, hq, hkv, s, d)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != (b, hkv, s, d):
        raise ValueError(f"k and v must be (B, Hkv, S, D) = "
                         f"{(b, hkv, s, d)}: got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype} "
                            "(q's)")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, expected {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return b, hq, hkv, s, d


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """Plain version of :func:`flash_attention`: dense softmax attention in
    float32, one KV head (and the ``Hq // Hkv`` query heads that share it)
    at a time, so the logits take (B, Hq/Hkv, S, S) floats and not
    (B, Hq, S, S).  Masked logits are ``-inf``; output in q's dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    mask = (torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    out = torch.empty_like(q)
    for j in range(hkv):
        heads = slice(j * group, (j + 1) * group)
        qf = q[:, heads].float() * scale            # (B, group, S, D)
        kf = k[:, j:j + 1].float()                  # (B, 1, S, D)
        logits = torch.matmul(qf, kf.transpose(-1, -2))
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out[:, heads] = torch.matmul(probs, v[:, j:j + 1].float()).to(q.dtype)
    return out


def _launch(q, k, v, causal: bool, scale: float):
    """One launch of the CUDA kernel for ``d`` = q's head dim; counts it.
    On meta tensors (a dry run) the launch is planned, not made: the output
    is allocated and the launch reported to the active op counters
    (``accounting.launch``), without the library or the count."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    out = torch.empty_like(q)
    if b * hq * s == 0:
        return out
    accounting.launch("flash_attention", (out,), flash_attention_plain,
                      q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * hq, hq, hkv, s, d, _DTYPES[q.dtype], int(causal),
            float(scale), stream)
    build.check(rc, "gx_flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with a gradient: the backward recomputes
    :func:`flash_attention_plain` from the saved inputs and differentiates
    it, so its gradients are plain autograd's on the same inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        return plain_grads(
            lambda *t: flash_attention_plain(*t, causal=ctx.causal,
                                             scale=ctx.scale),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (grad,)) + (None,
                                                                    None)


def plain_grads(fn, inputs, needs, grads):
    """A kernel Function's backward: the gradients of the plain version
    ``fn(*inputs)`` against ``grads`` (one per output), for the inputs
    flagged in ``needs`` (``None`` for the others).  The plain forward it
    recomputes is work the JAX package's backward does not do; an op
    counter counts it apart (``kernel_recompute_dot_flops``)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        with accounting.recompute():
            outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Forward attention with an online softmax; GQA by index, no repeat.

    Args: q (B, Hq, S, D); k, v (B, Hkv, S, D) with Hq % Hkv == 0; all
    three float32 or all bfloat16, contiguous, on one device.  ``scale``
    defaults to 1/sqrt(D) of the real D.  The CUDA kernels take D in
    ``HEAD_DIMS`` and any S (a partial last tile reads zeros past S and is
    masked).  Returns
    (B, Hq, S, D) in q's dtype.  On CUDA tensors under autograd, with an
    input that requires grad, the launch goes through an
    ``autograd.Function`` whose backward is plain PyTorch (the JAX package
    has no backward kernel either); on CPU tensors the plain version
    differentiates as it is.  Meta tensors take the CUDA branch, checks
    and ``autograd.Function`` included, with a planned launch (a dry run
    saves what the card saves).
    """
    b, hq, hkv, s, d = _check(q, k, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (meta for a "
                         f"dry run), got {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention's CUDA kernels take head dims "
                         f"{HEAD_DIMS}, got D={d}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


flash_attention.launches = 0
