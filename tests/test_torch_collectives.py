"""The port's compressed collectives (``repro_torch.dist.collectives``) and
``MeshUpperSystem(wire="compressed")`` against the JAX package's.

* The contracts of tests/test_collectives.py and the quantization /
  error-feedback ones of tests/test_dist_properties.py, on the port.
* Parity: the same float32 inputs (made with NumPy from a seed) through
  both packages' ``quantize_int``, ``compressed_allreduce_ref`` and
  ``make_compressed_allreduce`` (at the JAX package's device count n, its
  CPU devices): bit-equal, as both round half to even and keep the
  float32 operations in one order — except where XLA's fused CPU code of
  the jitted ``shard_map`` round rounds otherwise, or its ``psum`` adds
  the n devices in another order: its means within n·2^-23·max |t| (n
  float32 ulps of the payload; JAX's own oracle test allows one ulp at
  n = 1) and its residual ``t − q·scale`` within 2^-22·max |t|.
* m = 4 logical devices (beyond the JAX CPU run's one device) against the
  host oracle of the int8 wire (tests/test_collectives.py's
  ``_host_int8_wire``, rewritten here): bit-equal, where JAX's own test
  allows one float ulp.
* The five ``wire="compressed"`` contracts of tests/test_plug.py against
  the JAX ``MeshUpperSystem(wire="compressed")`` on the same graph, at the
  JAX package's m: states within atol 5e-3 of ``run_reference`` (the JAX
  tests' tolerance for int8, 5e-2 for int4) and within rtol 1e-5 / atol
  1e-8 of JAX's (the daemons' aggregates add float32 messages in other
  orders, and a quantization step can flip on that); equal
  ``wire_stats``; and merges on identical per-shard aggregates as close
  to JAX's as above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plug as jplug
from repro.dist import collectives as JC
from repro.graph import algorithms as jalg
from repro.graph import generate as jgenerate
from repro_torch import convert
from repro_torch import plug as tplug
from repro_torch.dist import collectives as C
from repro_torch.graph import algorithms as talg

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep — deterministic in-repo fallback
    from _hypothesis_fallback import given, settings, strategies as st

SHARDS = 2
BLOCK = 256
MAX_IT = 8


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _n():
    return len(jax.devices())


# --------------------------------------------------------------------------
# tests/test_collectives.py's contracts on the port
# --------------------------------------------------------------------------
def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((128, 64)))
    q, s = C.quantize_int8(x)
    err = (C.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-7


def test_compressed_allreduce_ref_matches_mean():
    rng = np.random.default_rng(1)
    locals_ = [_t(rng.standard_normal((32, 16))) for _ in range(4)]
    residuals = [torch.zeros((32, 16)) for _ in range(4)]
    means, new_res = C.compressed_allreduce_ref(locals_, residuals)
    true_mean = np.mean([x.numpy() for x in locals_], axis=0)
    np.testing.assert_allclose(means[0].numpy(), true_mean, atol=2e-2)
    for x, r in zip(locals_, new_res):
        assert float(r.abs().max()) < float(x.abs().max()) * 0.05
    with pytest.raises(ValueError, match="residual"):
        C.compressed_allreduce_ref(locals_, residuals[:3])


@pytest.mark.parametrize("bits", [8, 4])
def test_error_feedback_conserves_mass(bits):
    """20 rounds: the wire's total plus the last residual is the inputs'
    total — error feedback delays mass and never loses it."""
    rng = np.random.default_rng(2 + bits)
    res = torch.zeros(64)
    tot_in = np.zeros(64)
    tot_wire = np.zeros(64)
    for it in range(20):
        x = _t(rng.standard_normal(64) * 10.0 ** (it % 3 - 1))
        tot_in += x.numpy()
        q, s = C.quantize_int(x + res, bits)
        sent = C.dequantize_int(q, s)
        res = x + res - sent
        tot_wire += sent.numpy()
    np.testing.assert_allclose(tot_wire + res.numpy(), tot_in, atol=1e-4)


@pytest.mark.parametrize("m", [1, 4])
def test_stacked_compressed_allreduce_runs(m):
    """A (m·8,) leaf over m logical devices; at m = 1 the mean of one
    device is its own input, up to the int8 grid."""
    run = C.make_compressed_allreduce(m)
    x = {"g": torch.arange(m * 8, dtype=torch.float32)}
    r = {"g": torch.zeros(m * 8)}
    means, new_r = run(x, r)
    assert means["g"].shape == (m * 8,) and new_r["g"].shape == (m * 8,)
    if m == 1:
        np.testing.assert_allclose(means["g"].numpy(), x["g"].numpy(),
                                   rtol=2e-2, atol=2e-2)
    else:  # every device's slice holds the same mean
        got = means["g"].reshape(m, 8)
        assert all(torch.equal(got[0], got[j]) for j in range(m))


def _host_int8_wire(shards, bits=8):
    """Host oracle of the real int8 wire round (tests/test_collectives.py):
    scale all-gather → shared max scale → int32 accumulation → one
    dequantize; float32 throughout, in the device path's order."""
    qmax = (1 << (bits - 1)) - 1
    scales = [np.maximum(np.max(np.abs(x)), np.float32(1e-12))
              / np.float32(qmax) for x in shards]
    shared = np.max(np.stack(scales)).astype(np.float32)
    acc = np.zeros_like(shards[0], dtype=np.int32)
    for x in shards:
        q = np.clip(np.round(x / shared), -qmax, qmax).astype(np.int8)
        acc += q.astype(np.int32)
    return acc.astype(np.float32) * shared / np.float32(len(shards))


@pytest.mark.parametrize("wire", ["int8", "emulated"])
@pytest.mark.parametrize("m", [1, 4])
def test_wire_formats_approximate_true_mean(wire, m):
    run = C.make_compressed_allreduce(m, wire=wire)
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((m * 16,)))
    means, new_r = run(x, torch.zeros_like(x))
    true_mean = x.numpy().reshape(m, 16).mean(axis=0)
    got = means.numpy().reshape(m, 16)
    for j in range(m):
        np.testing.assert_allclose(got[j], true_mean, atol=5e-2)
    assert float(new_r.abs().max()) <= float(x.abs().max()) / 127


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_int_wire_matches_host_oracle_bit_for_bit(m, bits):
    """The stacked int wire equals the host oracle exactly at m logical
    devices (JAX's own test allows one ulp)."""
    run = C.make_compressed_allreduce(m, bits=bits)
    rng = np.random.default_rng(8 + m)
    x_host = rng.standard_normal((m, 32)).astype(np.float32)
    means, _ = run(_t(x_host.reshape(-1)), torch.zeros(m * 32))
    expect = _host_int8_wire([x_host[j] for j in range(m)], bits)
    got = means.numpy().reshape(m, 32)
    for j in range(m):
        np.testing.assert_array_equal(got[j], expect)


@pytest.mark.parametrize("m", [1, 4])
def test_int8_wire_error_feedback_conserves_mass(m):
    run = C.make_compressed_allreduce(m)
    rng = np.random.default_rng(9)
    res = torch.zeros(m * 8)
    tot_in = np.zeros(m * 8)
    tot_wire = np.zeros(m * 8)
    for _ in range(10):
        x = _t(rng.standard_normal(m * 8))
        tot_in += x.numpy()
        res_in = res
        _, res = run(x, res_in)
        tot_wire += x.numpy() + res_in.numpy() - res.numpy()
    np.testing.assert_allclose(tot_wire + res.numpy(), tot_in, atol=1e-4)


def test_wire_format_and_argument_validation():
    with pytest.raises(ValueError):
        C.make_compressed_allreduce(2, wire="fp4")
    with pytest.raises(ValueError, match="bits"):
        C.make_compressed_allreduce(2, bits=9)
    with pytest.raises(ValueError, match="bits"):
        C.quantize_int(torch.ones(3), bits=1)
    run = C.make_compressed_allreduce(4)
    with pytest.raises(ValueError, match="split"):
        run(torch.ones(6), torch.zeros(6))
    with pytest.raises(ValueError, match="residual"):
        run(torch.ones(8), torch.zeros(4))
    for mesh in (0, True, ("data", 2)):
        with pytest.raises(ValueError, match="logical devices"):
            C.make_compressed_allreduce(mesh)


def test_bytes_saved():
    assert C.collective_bytes_saved(1000) == 500
    assert C.collective_bytes_saved(1000, bits=4) == 750


# --------------------------------------------------------------------------
# tests/test_dist_properties.py's quantization contracts
# --------------------------------------------------------------------------
@settings(max_examples=50, deadline=None)
@given(scale_pow=st.integers(min_value=-3, max_value=3),
       seed=st.integers(min_value=0, max_value=1000))
def test_quantize_roundtrip_bound_int8_int4(scale_pow, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((64,)) * 10.0 ** scale_pow)
    for bits in (8, 4):
        q, s = C.quantize_int(x, bits)
        assert q.dtype == torch.int8
        qmax = (1 << (bits - 1)) - 1
        assert int(q.abs().max()) <= qmax
        err = (C.dequantize_int(q, s) - x).abs()
        assert float(err.max()) <= float(s) / 2 + 1e-6 * float(s)


def test_quantize_all_zero_input():
    q, s = C.quantize_int8(torch.zeros(16))
    assert int(q.abs().max()) == 0
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.zeros(16))


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_jax(bits, seed):
    rng = np.random.default_rng(seed)
    # halves land exactly on the grid's midpoints: both round to even
    x = (rng.integers(-40, 40, 257) / 2.0).astype(np.float32)
    x[0] = 40.0
    jq, js = JC.quantize_int(jnp.asarray(x), bits)
    tq, ts = C.quantize_int(_t(x), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    x = (rng.standard_normal((33, 7)) * 3).astype(np.float32)
    jq, js = JC.quantize_int(jnp.asarray(x), bits)
    tq, ts = C.quantize_int(_t(x), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(C.dequantize_int(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int(jq, js)))


def test_compressed_allreduce_ref_matches_jax():
    rng = np.random.default_rng(11)
    locs = [rng.standard_normal((16, 4)).astype(np.float32) for _ in range(3)]
    res = [(0.01 * rng.standard_normal((16, 4))).astype(np.float32)
           for _ in range(3)]
    jm, jr = JC.compressed_allreduce_ref([jnp.asarray(a) for a in locs],
                                         [jnp.asarray(a) for a in res])
    tm, tr = C.compressed_allreduce_ref([_t(a) for a in locs],
                                        [_t(a) for a in res])
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm[0]))
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("wire", ["int8", "emulated"])
@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_allreduce_matches_jax_shard_map(wire, bits):
    """Five error-feedback rounds of a dict leaf through JAX's shard_map
    (n CPU devices) and the port at m = n, each round from the same
    residual (JAX's): means within n·2^-23·max |t|, residuals within
    2^-22·max |t|."""
    n = _n()
    mesh = jax.make_mesh((n,), ("data",))
    jrun = JC.make_compressed_allreduce(mesh, "data", bits=bits, wire=wire)
    trun = C.make_compressed_allreduce(n, "data", bits=bits, wire=wire)
    rng = np.random.default_rng(12)
    jres = {"g": jnp.zeros((n * 24, 3), jnp.float32)}
    tres = {"g": torch.zeros((n * 24, 3))}
    for _ in range(5):
        x = (rng.standard_normal((n * 24, 3)) * 5).astype(np.float32)
        res_in = np.asarray(jres["g"])
        with mesh:
            jmean, jres = jrun({"g": jnp.asarray(x)}, jres)
        tmean, tres = trun({"g": _t(x)}, {"g": _t(res_in)})
        t_max = float(np.abs(x + res_in).max())
        np.testing.assert_allclose(tmean["g"].numpy(), np.asarray(jmean["g"]),
                                   rtol=0, atol=n * 2.0 ** -23 * t_max)
        np.testing.assert_allclose(tres["g"].numpy(), np.asarray(jres["g"]),
                                   rtol=0, atol=2.0 ** -22 * t_max)


# --------------------------------------------------------------------------
# MeshUpperSystem(wire="compressed"), tests/test_plug.py:158-230
# --------------------------------------------------------------------------
_graphs: dict = {}


def _graph():
    """(JAX graph, port graph): tests/test_plug.py's R-MAT."""
    if "g" not in _graphs:
        gj = jgenerate.rmat(256, 2048, seed=9)
        _graphs["g"] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs["g"]


def _reference():
    if "ref" not in _graphs:
        gj, _ = _graph()
        _graphs["ref"] = np.asarray(jplug.run_reference(
            gj, jalg.pagerank(gj), max_iterations=MAX_IT)[0])
    return _graphs["ref"]


def _pair(shards=SHARDS, bits=8, jax_upper=None, port_upper=None):
    """JAX's and the port's middlewares of the same composition over the
    compressed wire; the port's ``mesh`` is the JAX upper's m."""
    gj, gt = _graph()
    jup = jax_upper or jplug.MeshUpperSystem(wire="compressed", bits=bits)
    jmw = jplug.Middleware(gj, jalg.pagerank(gj), daemon="reference",
                           upper=jup, num_shards=shards,
                           options=jplug.PlugOptions(block_size=BLOCK))
    tup = port_upper or tplug.MeshUpperSystem(mesh=jup.m, wire="compressed",
                                              bits=bits)
    tmw = tplug.Middleware(gt, talg.pagerank(gt), daemon="reference",
                           upper=tup, num_shards=shards,
                           options=tplug.PlugOptions(block_size=BLOCK),
                           device="cpu")
    return jmw, jup, tmw, tup


@pytest.mark.parametrize("bits, atol", [(8, 5e-3), (4, 5e-2)])
def test_mesh_compressed_wire_runs_for_sum_monoid(bits, atol):
    """wire="compressed" pushes pagerank's aggregate through the int
    error-feedback wire: near run_reference, close to JAX's, with JAX's
    wire accounting (int4: the contract at 4 bits)."""
    jmw, jup, tmw, tup = _pair(bits=bits)
    jres = jmw.run(max_iterations=MAX_IT)
    tres = tmw.run(max_iterations=MAX_IT)
    assert tmw._fused_kind is None  # the compressed wire is the host loop's
    np.testing.assert_allclose(tres.state, _reference(), atol=atol)
    np.testing.assert_allclose(tres.state, np.asarray(jres.state),
                               rtol=1e-5, atol=1e-8)
    assert tres.iterations == jres.iterations
    assert tup.wire_stats == jup.wire_stats
    assert tup.wire_stats["compressed_bytes"] > 0
    assert tup.wire_stats["exact_bytes"] == 0


def test_mesh_compressed_wire_runs_are_reproducible():
    """Repeated run() calls start from a cleared error-feedback residual."""
    _, _, tmw, tup = _pair()
    a = tmw.run(max_iterations=6).state
    stats = dict(tup.wire_stats)
    b = tmw.run(max_iterations=6).state
    np.testing.assert_array_equal(a, b)
    assert tup.wire_stats == stats  # the counters restart with every run


@pytest.mark.parametrize("compressed", [False, True])
def test_mesh_upper_rebind_across_shard_counts(compressed):
    """One upper reused across shard layouts rebuilds m, the wire and the
    residual for each (the exact wire's and the compressed wire's
    contracts)."""
    _, gt = _graph()
    wire = "compressed" if compressed else "exact"
    upper = tplug.MeshUpperSystem(mesh=None, wire=wire)
    for shards in (2, 4):
        upper.mesh = shards  # m logical devices = the shard count
        mw = tplug.Middleware(gt, talg.pagerank(gt), daemon="reference",
                              upper=upper, num_shards=shards,
                              options=tplug.PlugOptions(block_size=BLOCK),
                              device="cpu")
        assert upper.m == shards and upper._residual is None
        res = mw.run(max_iterations=MAX_IT)
        np.testing.assert_allclose(res.state, _reference(),
                                   atol=5e-3 if compressed else 1e-6)
        if compressed:
            assert tuple(upper._residual.shape) == (shards, gt.num_vertices,
                                                    1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shards", [1, 2])
def test_compressed_merge_matches_jax(bits, shards):
    """Four rounds of identical per-shard aggregates through both uppers'
    merge (at the JAX package's m): the first aggregate (a fresh residual)
    within one float32 ulp of JAX's; later ones, whose carried residuals
    differ in their last bits (XLA's fused rounding), within one
    quantization step of each of the m devices."""
    gj, gt = _graph()
    jup = jplug.MeshUpperSystem(wire="compressed", bits=bits).bind(
        jalg.pagerank(gj), shards)
    tup = tplug.MeshUpperSystem(mesh=jup.m, wire="compressed",
                                bits=bits).bind(talg.pagerank(gt), shards)
    jup.reset()
    tup.reset()
    n = gt.num_vertices
    rng = np.random.default_rng(13)
    qmax = (1 << (bits - 1)) - 1
    for i in range(4):
        states = [rng.random((n, 1)).astype(np.float32)] * shards
        aggs = [(rng.pareto(1.5, (n, 1)) * 1e-3).astype(np.float32)
                for _ in range(shards)]
        cnts = [rng.integers(0, 3, n).astype(np.int32) for _ in range(shards)]
        jb, ja, jc = jup.merge(states, aggs, cnts)
        tb, ta, tc = tup.merge(states, aggs, cnts)
        if i == 0:
            np.testing.assert_allclose(ta, np.asarray(ja), rtol=2.0 ** -23,
                                       atol=0)
        else:
            step = jup.m * float(np.abs(np.asarray(ja)).max()) / qmax
            np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=step)
        np.testing.assert_array_equal(tb, np.asarray(jb))
        np.testing.assert_array_equal(tc, np.asarray(jc))
    assert tup.wire_stats == jup.wire_stats


def test_compressed_wire_refusals():
    """As the JAX package's: an idempotent monoid is refused at bind, and
    the fused loops' merges refuse the compressed wire (its residual is
    the host loop's per-run state)."""
    _, gt = _graph()
    with pytest.raises(ValueError, match="idempotent"):
        tplug.MeshUpperSystem(wire="compressed").bind(talg.sssp_bf(gt), 2)
    up = tplug.MeshUpperSystem(mesh=2, wire="compressed").bind(
        talg.pagerank(gt), 2)
    p, c = torch.zeros((2, 4, 1)), torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="exact"):
        up.merge_partials(p, c)
    with pytest.raises(ValueError, match="exact"):
        up.merge_partials_async(p, c, p, c, 0.0, 0.0)
    # the sharded daemon with the compressed wire keeps the host loop
    mw = tplug.Middleware(gt, talg.pagerank(gt),
                          daemon=tplug.ShardedDaemon(kernel="cuda"),
                          upper=tplug.MeshUpperSystem(mesh=2,
                                                      wire="compressed"),
                          num_shards=2,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert mw._fused_kind is None


def test_compressed_wire_folds_on_the_bound_device():
    """The upper keeps the device ``bind`` hands it (the middleware's own),
    a rebind without one keeps it, and the residual lies there."""
    _, gt = _graph()
    prog = talg.pagerank(gt)
    up = tplug.MeshUpperSystem(mesh=2, wire="compressed")
    assert up.bind(prog, 4, device="cpu").device == torch.device("cpu")
    assert up.remesh(1).device == torch.device("cpu")
    upper = tplug.MeshUpperSystem(mesh=2, wire="compressed")
    mw = tplug.Middleware(gt, prog, upper=upper, num_shards=2,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert upper.device == mw.device
    mw.run(max_iterations=2)
    assert upper._residual.device == mw.device
