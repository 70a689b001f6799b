"""The port's attention and Mamba2-SSD kernels against the JAX package's.

On the CPU: the port's entry points (``kernels/ops.flash_attention`` and
``ops.ssd_scan``, which run the kernels' plain versions on CPU tensors) and
oracles against the JAX package's, the Pallas kernels in interpret mode.
Inputs are made with numpy from a seed and handed to both; bfloat16 inputs
are cast in each package (both round to nearest even).  Tolerances:
attention atol 2e-5 (f32) and 2e-2 (bf16, one rounding of the output), the
within-chunk SSD step 1e-5 (and, with dt in Mamba2's range where decay and
gate do not underflow, those two within 1e-5·|want| per element), the full
SSD scan 2e-4 (the tolerances of
tests/test_kernels.py; float32 sums in another order).

The CUDA kernels themselves are held against these plain versions on the
card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

ATTN_SHAPES = [
    (1, 4, 4, 128, 32),     # MHA
    (2, 8, 2, 256, 64),     # GQA 4:1
    (2, 6, 1, 192, 64),     # MQA, non-pow2 seq blocks
    (2, 4, 2, 64, 16),      # the reduced configs' heads (d_model 64 / 4)
    (1, 8, 1, 128, 128),    # qwen2-72b's 8:1 GQA at its head dim
    (1, 4, 2, 128, 80),     # zamba2-2.7b's head dim (2560 / 32)
]
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (2, 96, 4, 16, 4, 8, 32),
    (1, 512, 2, 16, 1, 8, 256),  # mamba2-1.3b's chunk
]


def _attn_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _ssd_inputs(seed, b, s, h, p, g, n, dt="softplus"):
    """As tests/test_kernels.py makes them: 0.5·N(0,1) x, softplus(N(0,1))
    dt, a = −exp(0.3·N(0,1)), 0.3·N(0,1) B and C; with ``dt="mamba2"``, dt
    log-uniform in Mamba2's range 1e-3..1e-1 instead, where a chunk's decay
    and gate stay normal floats."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, s, h, p))
    if dt == "softplus":
        dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)))
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    a = -np.exp(0.3 * rng.standard_normal(h))
    bm = 0.3 * rng.standard_normal((b, s, g, n))
    cm = 0.3 * rng.standard_normal((b, s, g, n))
    return [np.asarray(t, np.float32) for t in (x, dt, a, bm, cm)]


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(b, hq, hkv, s, d, dtype, causal):
    arrs = _attn_inputs(hq * s + d, b, hq, hkv, s, d)
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    want_pal = jops.flash_attention(*jargs, causal=causal, impl="pallas",
                                    block_q=64, block_k=64)
    want_ref = jops.flash_attention(*jargs, causal=causal, impl="reference")
    got = tops.flash_attention(*targs, causal=causal, block_q=64, block_k=64)
    got_ref = tops.flash_attention(*targs, causal=causal, impl="reference")
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (b, hq, s, d)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (want_pal, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)
        np.testing.assert_allclose(_f32(got_ref), _f32(want), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("dts", ["softplus", "mamba2"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_chunk_matches_pallas(b, s, h, p, g, n, chunk, dts):
    """All four outputs of the within-chunk step; the port reads B and C by
    group, the JAX kernel takes them expanded to the heads.  With dt in
    Mamba2's range, decay and gate are also held per element (rtol 1e-5)."""
    x, dt, a, bm, cm = _ssd_inputs(s + h, b, s, h, p, g, n, dts)
    nc = s // chunk

    def chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    bh, ch = (np.repeat(m, h // g, axis=2) for m in (bm, cm))
    want = ssd_chunk_pallas(*(jnp.asarray(t) for t in (
        chunks(x), chunks(dt), a, chunks(bh), chunks(ch))), interpret=True)
    got = tss.ssd_chunk(*(torch.from_numpy(np.ascontiguousarray(t)) for t in (
        chunks(x), chunks(dt), a, chunks(bm), chunks(cm))))
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        assert tuple(gt.shape) == wt.shape, name
        np.testing.assert_allclose(_f32(gt), _f32(wt), atol=1e-5, rtol=0,
                                   err_msg=name)
        if dts == "mamba2" and name in ("decay", "gate"):
            assert np.abs(_f32(wt)).min() > 1e-30, name
            np.testing.assert_allclose(_f32(gt), _f32(wt), atol=0,
                                       rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_matches_jax(b, s, h, p, g, n, chunk):
    arrs = _ssd_inputs(s * h + g, b, s, h, p, g, n)
    jargs = [jnp.asarray(t) for t in arrs]
    targs = [torch.from_numpy(t) for t in arrs]
    got = tops.ssd_scan(*targs, chunk=chunk)
    got_ref = tops.ssd_scan(*targs, chunk=chunk, impl="reference")
    got_seq = tref.ssd_scan_reference(*targs)
    wants = (jops.ssd_scan(*jargs, chunk=chunk, impl="pallas"),
             jops.ssd_scan(*jargs, chunk=chunk, impl="reference"),
             jref.ssd_scan_reference(*jargs))
    for mine in (got, got_ref, got_seq):
        assert mine.dtype == torch.float32 and tuple(mine.shape) == (b, s, h, p)
        for want in wants:
            np.testing.assert_allclose(_f32(mine), _f32(want), atol=2e-4,
                                       rtol=0)


def test_ssd_chunked_ref_final_state_matches_jax():
    b, s, h, p, g, n = 2, 64, 2, 16, 1, 8
    arrs = _ssd_inputs(9, b, s, h, p, g, n)
    y_j, st_j = jref.ssd_scan_chunked_ref(*(jnp.asarray(t) for t in arrs),
                                          chunk=16, return_final_state=True)
    y_t, st_t = tref.ssd_scan_chunked_ref(*(torch.from_numpy(t)
                                            for t in arrs),
                                          chunk=16, return_final_state=True)
    assert tuple(st_t.shape) == (b, h, n, p)
    np.testing.assert_allclose(_f32(st_t), _f32(st_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), atol=1e-5, rtol=0)


def test_ssd_chunk_local_matches_jax():
    b, l, h, p, n = 2, 32, 3, 16, 8
    x, dt, a, bm, cm = _ssd_inputs(4, b, l, h, p, h, n)
    want = jref.ssd_chunk_local(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    got = tref.ssd_chunk_local(*(torch.from_numpy(t)
                                 for t in (x, dt, a, bm, cm)))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(_f32(gt), _f32(wt), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["hq_not_multiple_of_hkv", "s_not_in_blocks"])
def test_attention_refuses_what_jax_refuses(case):
    b, hq, hkv, s, d, blk = 1, 4, 4, 128, 32, 64
    if case == "hq_not_multiple_of_hkv":
        hkv = 3
    else:
        blk = 48  # 128 % 48 != 0
    arrs = _attn_inputs(0, b, hq, hkv, s, d)
    with pytest.raises(AssertionError):
        jops.flash_attention(*(jnp.asarray(t) for t in arrs), impl="pallas",
                             block_q=blk, block_k=blk)
    with pytest.raises(ValueError, match="Hkv|blocks"):
        tops.flash_attention(*(torch.from_numpy(t) for t in arrs),
                             block_q=blk, block_k=blk)


@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_ssd_scan_refuses_seq_not_in_chunks(impl):
    arrs = _ssd_inputs(0, 1, 48, 2, 16, 1, 8)
    jimpl = "pallas" if impl == "cuda" else impl
    with pytest.raises(AssertionError):
        jops.ssd_scan(*(jnp.asarray(t) for t in arrs), chunk=32, impl=jimpl)
    with pytest.raises(ValueError, match="chunk"):
        tops.ssd_scan(*(torch.from_numpy(t) for t in arrs), chunk=32,
                      impl=impl)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 2, 200, 64), (1, 4, 4, 64, 16)])
def test_attention_gradients_match_jax(shape, causal):
    """The gradient of the kernel's wrapper, which the model calls (on CPU
    tensors the plain version, which differentiates natively; on the card
    the kernel's ``autograd.Function``, whose backward is this plain
    version) against ``jax.vjp`` of the JAX package's oracle, float32,
    atol 2e-5 — at an S that is no multiple of 128 too."""
    from repro_torch.kernels import flash_attention as tfa

    import jax

    q, k, v = _attn_inputs(5, *shape)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: jref.flash_attention(*t, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        tfa.flash_attention(*xs, causal=causal), xs, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("shape", SSD_SHAPES[:3])
def test_ssd_scan_gradients_match_jax(shape):
    """The gradient of ``ops.ssd_scan`` (the within-chunk step's plain
    version on CPU tensors and the cross-chunk loop, as the card runs
    around its kernel) against ``jax.vjp`` of the JAX package's
    ``ssd_scan_chunked_ref``, every input, within 2e-4·max(1, max |want|)
    (the scan's float32 tolerance)."""
    import jax

    b, s, h, p, g, n, chunk = shape
    inputs = _ssd_inputs(7, b, s, h, p, g, n, dt="mamba2")
    gy = np.random.default_rng(8).standard_normal((b, s, h, p)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *t: jref.ssd_scan_chunked_ref(*t, chunk=chunk),
                     *map(jnp.asarray, inputs))
    want = vjp(jnp.asarray(gy))
    xs = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    got = torch.autograd.grad(tops.ssd_scan(*xs, chunk=chunk), xs,
                              torch.from_numpy(gy))
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(w).max()))


def test_kernel_functions_backward_on_the_cpu(monkeypatch):
    """The kernels' ``autograd.Function``s with the launch stood in by the
    plain version (the CUDA launch needs a card): their backward gives
    plain autograd's gradients bit for bit, for every input and for a
    subset of them, and for the SSD step's four outputs."""
    from repro_torch.kernels import flash_attention as tfa

    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, causal, scale:
                        tfa.flash_attention_plain(q, k, v, causal=causal,
                                                  scale=scale))
    monkeypatch.setattr(tss, "_launch", tss.ssd_chunk_plain)
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(3, 2, 4, 2, 40,
                                                          16))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    for needs in ((True, True, True), (False, True, False)):
        xs = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = tfa._FlashAttention.apply(*xs, False, 0.25)
        got = torch.autograd.grad(out, [x for x in xs if x.requires_grad], g)
        ys = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        want = torch.autograd.grad(
            tfa.flash_attention_plain(*ys, causal=False, scale=0.25),
            [y for y in ys if y.requires_grad], g)
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    x, dt, a, bm, cm = (torch.from_numpy(t) for t in _ssd_inputs(
        4, 2, 32, 4, 16, 2, 8, dt="mamba2"))
    chunked = (x.reshape(2, 2, 16, 4, 16), dt.reshape(2, 2, 16, 4), a,
               bm.reshape(2, 2, 16, 2, 8), cm.reshape(2, 2, 16, 2, 8))
    gen = torch.Generator().manual_seed(2)
    outs_g = [torch.randn(o.shape, generator=gen)
              for o in tss.ssd_chunk_plain(*chunked)]
    xs = [t.clone().requires_grad_(True) for t in chunked]
    got = torch.autograd.grad(tss._SSDChunk.apply(*xs), xs, outs_g)
    ys = [t.clone().requires_grad_(True) for t in chunked]
    want = torch.autograd.grad(tss.ssd_chunk_plain(*ys), ys, outs_g)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    # an output that gets no gradient (only y's)
    xs = [t.clone().requires_grad_(True) for t in chunked]
    y = tss._SSDChunk.apply(*xs)[0]
    got = torch.autograd.grad(y, xs, outs_g[0])
    ys = [t.clone().requires_grad_(True) for t in chunked]
    want = torch.autograd.grad(tss.ssd_chunk_plain(*ys)[0], ys, outs_g[0])
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
