"""The port's shard axis of m logical devices on one card
(``plug.protocols.divisor_mesh``, ``ShardedDaemon.run_all_shards``,
``MeshUpperSystem``) against a numpy oracle and the JAX package, on the
CPU.

* For m ∈ {1, 2, 4} over 4 shards and m = 8 over 8 shards,
  ``run_all_shards`` returns (m, N, K) partials and (m, N) counts, logical
  device g folding the contiguous shards g·S/m … (g+1)·S/m − 1: they
  equal a numpy fold of each group's edges (min bit for bit, sum within
  rtol=1e-5, atol=1e-6), for the block body, the CSR-tile kernel and the
  flat merge.
* The fused loop at m equals the fused loop at m = 1 and the JAX
  package's fused loop (at whatever m the JAX process's devices give it):
  state, iterations and every record; ``merge_partials`` receives
  (m, N, K).
* The mesh upper's merge at the JAX package's m equals the JAX merge, its
  ``wire_stats`` included.  The JAX m is read from the JAX object, so no
  assertion depends on how many devices the JAX process has.
* Bad meshes are refused: an int that does not divide the shards or is
  under 1 with ``ValueError``, a device mesh (item 13c) with
  ``NotImplementedError``.
"""
import numpy as np
import pytest
import torch

from repro import plug as jplug
from repro.graph import algorithms as jalg
from repro_torch import plug as tplug
from repro_torch.graph import algorithms as talg
from repro_torch.kernels.autotune import CSRConfig
from repro_torch.plug.daemons import _live_edges
from repro_torch.plug.protocols import divisor_mesh
from test_torch_fused import (BLOCK, KERNELS, PROGRAMS, RECORD_KEYS,
                              SUM_ATOL, SUM_RTOL, _assert_same_run, _graph,
                              _jax_run, _max_it)

MESHES = [(4, 1), (4, 2), (4, 4), (8, 8)]  # (shards, m)
FLAT = CSRConfig(edge_tile=256, lowering="torch", merge="flat")
# daemon configurations: the block body, the pinned kernel, the flat merge
DAEMONS = {"reference": dict(kernel="reference"),
           "cuda": dict(kernel="cuda", csr_config=CSRConfig()),
           "cuda-flat": dict(kernel="cuda", csr_config=FLAT)}

_port_runs: dict = {}


def _port(prog_name, daemon="cuda", shards=4, m=None, **kw):
    _, gt = _graph(prog_name)
    return tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt),
        daemon=tplug.ShardedDaemon(**DAEMONS[daemon]),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=shards,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu", **kw)


def _assert_close(monoid, got, want):
    if monoid.idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)


def _group_oracle(mw, m):
    """Each logical device's (N, K) fold and (N,) counts, in numpy, over
    the live edges of its contiguous shards (every edge active)."""
    prog, n = mw.program, mw.n
    state, aux = prog.init(mw.graph)
    monoid = prog.monoid
    per = mw.num_shards // m
    aggs, cnts = [], []
    for g in range(m):
        agg = np.full((n, prog.state_width), monoid.identity, np.float32)
        cnt = np.zeros(n, np.int64)
        for bs in mw.blocksets[g * per:(g + 1) * per]:
            src, dst, w = _live_edges(bs)
            aux1 = aux if aux.shape[1] else np.zeros((n, 1), np.float32)
            msgs = prog.msg_gen(*(torch.from_numpy(a) for a in (
                state[src], state[dst], w[:, None], aux1[src]))).numpy()
            if monoid.idempotent:
                ufunc = np.minimum if monoid.name == "min" else np.maximum
                ufunc.at(agg, dst, msgs)
            else:
                np.add.at(agg, dst, msgs)
            cnt += np.bincount(dst, minlength=n)
        aggs.append(agg)
        cnts.append(cnt)
    return np.stack(aggs), np.stack(cnts)


@pytest.mark.parametrize("shards, m", MESHES)
@pytest.mark.parametrize("daemon", sorted(DAEMONS))
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank", "label_prop"])
def test_run_all_shards_partials_match_a_per_group_oracle(prog_name, daemon,
                                                          shards, m):
    mw = _port(prog_name, daemon, shards, m)
    assert mw.daemon.m == m and mw.upper.m == m
    state, aux = (torch.from_numpy(a) for a in mw.program.init(mw.graph))
    partials, counts, blocks_run = mw.daemon.run_all_shards(state, aux)
    k = mw.program.state_width
    assert partials.shape == (m, mw.n, k) and counts.shape == (m, mw.n)
    assert counts.dtype == torch.int32 and blocks_run.shape == (shards,)
    want, want_c = _group_oracle(mw, m)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    _assert_close(mw.program.monoid, partials.numpy(), want)


def _recorded_merge(upper, shapes):
    merge = upper.merge_partials

    def wrapper(partials, counts):
        shapes.append((tuple(partials.shape), tuple(counts.shape)))
        return merge(partials, counts)

    upper.merge_partials = wrapper


@pytest.mark.parametrize("shards, m", MESHES)
@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_fused_loop_at_m_matches_m1_and_jax(prog_name, kernel, shards, m):
    mw = _port(prog_name, kernel, shards, m)
    assert mw._fused_kind == "bsp" and mw.daemon.m == m
    shapes: list = []
    _recorded_merge(mw.upper, shapes)
    res = mw.run(max_iterations=_max_it(prog_name))
    assert shapes == [((m, mw.n, mw.k), (m, mw.n))] * res.iterations
    key = (prog_name, kernel, shards)
    if key not in _port_runs:
        _port_runs[key] = _port(prog_name, kernel, shards, 1).run(
            max_iterations=_max_it(prog_name))
    for want in (_port_runs[key],
                 _jax_run(prog_name, "bsp", KERNELS[kernel], shards)):
        _assert_same_run(prog_name, res, want)
        for rec in RECORD_KEYS:
            assert [r[rec] for r in res.per_iteration] == \
                [r[rec] for r in want.per_iteration], rec


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_mesh_merge_matches_jax_at_its_m(prog_name, shards):
    """The host loop's merge at the JAX upper's m (read from it) equals the
    JAX merge, wire_stats included; at every other m the result is the
    same."""
    gj, gt = _graph(prog_name)
    pj, pt = jalg.ALGORITHMS[prog_name](gj), talg.ALGORITHMS[prog_name](gt)
    uj = jplug.MeshUpperSystem().bind(pj, shards)
    rng = np.random.default_rng(shards)
    shape = (gt.num_vertices, pt.state_width)
    states = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(shards)]
    aggs = [rng.standard_normal(shape).astype(np.float32)
            for _ in range(shards)]
    cnts = [rng.integers(0, 3, gt.num_vertices).astype(np.int32)
            for _ in range(shards)]
    want = uj.merge(states, aggs, cnts)
    for m in sorted({uj.m, 1, 2, 4, shards}):
        ut = tplug.MeshUpperSystem(mesh=m).bind(pt, shards)
        got = ut.merge(states, aggs, cnts)
        for g, w in zip(got, want):
            _assert_close(pt.monoid, g, np.asarray(w))
        assert ut.wire_stats["exact_bytes"] == 4 * np.prod(shape) * m
        if m == uj.m:
            assert ut.wire_stats == uj.wire_stats


def test_merge_partials_folds_the_groups_in_order():
    _, gt = _graph("pagerank")
    ut = tplug.MeshUpperSystem(mesh=4).bind(talg.pagerank(gt), 4)
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal((4, 8, 1)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 3, (4, 8)).astype(np.int32))
    agg, cnt = ut.merge_partials(p, c)
    torch.testing.assert_close(agg, ((p[0] + p[1]) + p[2]) + p[3], rtol=0,
                               atol=0)
    assert torch.equal(cnt, c.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("mesh, error", [
    (3, ValueError), (0, ValueError), (-4, ValueError), (8, ValueError),
    (object(), NotImplementedError), (("shard", 2), NotImplementedError),
    (True, NotImplementedError), (4.0, NotImplementedError)])
def test_bad_meshes_are_refused(mesh, error):
    match = "item 13" if error is NotImplementedError else "divide"
    with pytest.raises(error, match=match):
        divisor_mesh(4, mesh)
    with pytest.raises(error, match=match):
        _port("sssp_bf", m=mesh)
    _, gt = _graph("sssp_bf")
    daemon = tplug.ShardedDaemon(mesh=mesh).bind(
        talg.sssp_bf(gt), gt.num_vertices, device="cpu")
    with pytest.raises(error, match=match):
        daemon.bind_shards(_port("sssp_bf", "reference").blocksets)


def test_good_meshes_are_taken():
    assert divisor_mesh(4) == 1
    assert [divisor_mesh(8, m) for m in (1, 2, 4, 8)] == [1, 2, 4, 8]
    assert divisor_mesh(6, np.int64(3)) == 3
    with pytest.raises(ValueError, match="at least one shard"):
        divisor_mesh(0, 1)


def test_share_from_compares_m():
    """A donor's stacked tensors are adopted by a daemon at its m, and by
    none at another m."""
    donor = _port("bfs", m=2)
    _, gt = _graph("bfs")

    def twin(m):
        return tplug.Middleware(
            gt, talg.bfs(gt), upper=tplug.MeshUpperSystem(mesh=m),
            num_shards=4,
            daemon=tplug.ShardedDaemon(**DAEMONS["cuda"]).share_from(
                donor.daemon),
            options=tplug.PlugOptions(block_size=BLOCK), device="cpu")

    same, other = twin(2), twin(4)
    assert same.daemon.adopted_fields == 13
    assert other.daemon.adopted_fields == 0
    want = tplug.run_reference(gt, talg.bfs(gt), device="cpu")[0]
    for mw in (same, other):
        np.testing.assert_array_equal(mw.run().state, want)
