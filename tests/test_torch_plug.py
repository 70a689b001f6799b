"""The port's ``Middleware`` (host drive loop) against the JAX package's
``Middleware`` of the same composition and against the JAX
``run_reference``, on the same graph and initial state.

Matrix: programs × models {bsp, gas} × daemons {reference, cuda, blocked}
× num_shards {1, 4}, on the CPU (the ``cuda`` daemon runs the CSR-tile
kernel's plain version there).  The JAX composition for the port's
``"cuda"`` daemon is its ``"reference"`` daemon: the JAX ``"pallas"``
daemon autotunes over interpret-mode kernels, and the kernels themselves
are held against Pallas in tests/test_torch_kernels.py.

* min programs (sssp_bf, wcc, bfs) run to convergence and must match bit
  for bit, with equal iteration counts and equal ``SyncStats``;
* sum programs (pagerank, label_prop) run a fixed ``MAX_IT`` iterations
  and must match within rtol=1e-5, atol=1e-6 — shard aggregates and
  segment sums add float32 messages in another order than XLA does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import plug as jplug
from repro.graph import algorithms as jalg
from repro.graph import generate as jgenerate
from repro_torch import convert
from repro_torch import plug as tplug
from repro_torch.graph import algorithms as talg
from repro_torch.kernels.ops import CSRConfig

MAX_IT = 12
BLOCK = 256
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ["pagerank", "sssp_bf", "wcc", "bfs", "label_prop"]
JAX_DAEMON = {"reference": "reference", "cuda": "reference",
              "blocked": "blocked"}

_graphs: dict = {}
_jax_runs: dict = {}
_jax_refs: dict = {}


def _graph(prog_name):
    """(JAX graph, port graph) — the port's carried across as arrays."""
    if prog_name not in _graphs:
        gj = jgenerate.rmat(512, 4096, seed=7)
        if prog_name == "wcc":
            gj = gj.with_reverse_edges()
        _graphs[prog_name] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[prog_name]


def _max_it(prog_name):
    return MAX_IT if prog_name in ("pagerank", "label_prop") else None


def _jax_run(prog_name, model, daemon, shards):
    key = (prog_name, model, JAX_DAEMON[daemon], shards)
    if key not in _jax_runs:
        gj, _ = _graph(prog_name)
        mw = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                              daemon=JAX_DAEMON[daemon], model=model,
                              num_shards=shards,
                              options=jplug.PlugOptions(block_size=BLOCK))
        _jax_runs[key] = mw.run(max_iterations=_max_it(prog_name))
    return _jax_runs[key]


def _jax_reference(prog_name):
    if prog_name not in _jax_refs:
        gj, _ = _graph(prog_name)
        _jax_refs[prog_name] = jplug.run_reference(
            gj, jalg.ALGORITHMS[prog_name](gj),
            max_iterations=_max_it(prog_name))
    return _jax_refs[prog_name]


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("daemon", ["reference", "cuda", "blocked"])
@pytest.mark.parametrize("model", ["bsp", "gas"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_middleware_matches_jax(prog_name, model, daemon, shards):
    _, gt = _graph(prog_name)
    prog = talg.ALGORITHMS[prog_name](gt)
    # "cuda": the CSR-tile kernel at its pinned config
    backend = (tplug.VectorizedDaemon(kernel="cuda", csr_config=CSRConfig())
               if daemon == "cuda" else daemon)
    mw = tplug.Middleware(gt, prog, daemon=backend, model=model,
                          num_shards=shards,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    res = mw.run(max_iterations=_max_it(prog_name))
    want = _jax_run(prog_name, model, daemon, shards)
    ref_state, ref_it = _jax_reference(prog_name)
    assert res.state.shape == want.state.shape
    assert res.iterations == want.iterations
    assert res.converged == want.converged
    assert res.stats.as_dict() == want.stats.as_dict()
    assert [r.get("blocks_run") for r in res.per_iteration] == \
        [r.get("blocks_run") for r in want.per_iteration]
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(res.state, np.asarray(want.state))
        np.testing.assert_array_equal(res.state, ref_state)
        assert res.converged
    else:
        np.testing.assert_allclose(res.state, np.asarray(want.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
        np.testing.assert_allclose(res.state, ref_state, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
        assert res.iterations == ref_it == MAX_IT


@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_run_reference_matches_jax(prog_name):
    gj, gt = _graph(prog_name)
    state, it = tplug.run_reference(gt, talg.ALGORITHMS[prog_name](gt),
                                    max_iterations=_max_it(prog_name),
                                    device="cpu")
    want, want_it = _jax_reference(prog_name)
    assert it == want_it
    if prog_name in ("pagerank", "label_prop"):
        np.testing.assert_allclose(state, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(state, want)


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_run_reference_matches_jax_after_each_iteration(prog_name,
                                                        iterations):
    """The oracle's state after each of the first iterations, not only at
    the end."""
    gj, gt = _graph(prog_name)
    state, it = tplug.run_reference(gt, talg.ALGORITHMS[prog_name](gt),
                                    max_iterations=iterations, device="cpu")
    want, want_it = jplug.run_reference(gj, jalg.ALGORITHMS[prog_name](gj),
                                        max_iterations=iterations)
    assert it == want_it == iterations
    if prog_name in ("pagerank", "label_prop"):
        np.testing.assert_allclose(state, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(state, want)


@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_program_init_matches_jax(prog_name):
    """The programs start from identical state (``convert.program_inputs``
    carries the JAX program's init across)."""
    gj, gt = _graph(prog_name)
    sj, aj = convert.program_inputs(jalg.ALGORITHMS[prog_name](gj), gj,
                                    device="cpu")
    st, at = talg.ALGORITHMS[prog_name](gt).init(gt)
    assert torch.equal(sj, torch.from_numpy(st))
    assert torch.equal(aj, torch.from_numpy(at))


@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_msg_apply_matches_jax(prog_name):
    """One MSGApply step on the same arrays, through each package's apply
    wrapper (the has_msg masking included)."""
    import jax.numpy as jnp

    gj, gt = _graph(prog_name)
    pj, pt = jalg.ALGORITHMS[prog_name](gj), talg.ALGORITHMS[prog_name](gt)
    state, aux = pt.init(gt)
    rng = np.random.default_rng(1)
    merged = rng.uniform(0.0, 3.0, state.shape).astype(np.float32)
    has = rng.random(state.shape[0]) < 0.7
    nj, aj = jplug.make_apply_fn(pj)(jnp.asarray(state), jnp.asarray(merged),
                                     jnp.asarray(has), jnp.asarray(aux), 3)
    nt, at = tplug.make_apply_fn(pt, "cpu")(state, merged, has, aux, 3)
    np.testing.assert_array_equal(at, np.asarray(aj))
    if pt.monoid.idempotent:
        np.testing.assert_array_equal(nt, np.asarray(nj))
    else:
        np.testing.assert_allclose(nt, np.asarray(nj), rtol=1e-6, atol=0)


def test_capacity_aware_partitions_and_explicit_partitions_match_jax():
    gj, gt = _graph("sssp_bf")
    caps = [1.0, 2.0, 4.0]
    mj = jplug.Middleware(gj, jalg.sssp_bf(gj), num_shards=3,
                          capacities=caps,
                          options=jplug.PlugOptions(block_size=BLOCK))
    mt = tplug.Middleware(gt, talg.sssp_bf(gt), num_shards=3,
                          capacities=caps,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert [p.num_edges for p in mj.partitions] == \
        [p.num_edges for p in mt.partitions]
    rj, rt = mj.run(), mt.run()
    np.testing.assert_array_equal(rt.state, np.asarray(rj.state))
    assert rt.stats.as_dict() == rj.stats.as_dict()
    again = tplug.Middleware(gt, talg.sssp_bf(gt), partitions=mt.partitions,
                             options=tplug.PlugOptions(block_size=BLOCK),
                             device="cpu").run()
    np.testing.assert_array_equal(again.state, rt.state)


def test_auto_block_size_matches_jax():
    gj, gt = _graph("bfs")
    for shards in (1, 4):
        mj = jplug.Middleware(gj, jalg.bfs(gj), num_shards=shards)
        mt = tplug.Middleware(gt, talg.bfs(gt), num_shards=shards,
                              device="cpu")
        assert (mj.block_size, mj.vblock_size) == (mt.block_size,
                                                   mt.vblock_size)


def test_repeated_runs_reset_stats_and_daemon_instances_work():
    _, gt = _graph("sssp_bf")
    prog = talg.sssp_bf(gt)
    daemon = tplug.VectorizedDaemon(kernel="cuda", csr_config=CSRConfig())
    mw = tplug.Middleware(gt, prog, daemon=daemon, num_shards=4,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    a, b = mw.run(), mw.run()
    np.testing.assert_array_equal(a.state, b.state)
    assert a.stats.as_dict() == b.stats.as_dict()
    assert a.stats.rounds_total == a.iterations
    mw.run(init=lambda g: prog.init(g))  # init override seam
    frontier = np.zeros(gt.num_vertices, bool)
    quiet = mw.run(frontier=frontier)  # nothing active: no messages
    np.testing.assert_array_equal(quiet.state, prog.init(gt)[0])


def test_blocked_daemon_records_sequential_stages():
    _, gt = _graph("bfs")
    mw = tplug.Middleware(gt, talg.bfs(gt), daemon="blocked", num_shards=2,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    res = mw.run()
    assert all("sequential" in r for r in res.per_iteration)


def test_unknown_monoid_raises_in_blocked_upload():
    from repro_torch.core.template import Monoid

    _, gt = _graph("wcc")
    prog = dataclasses.replace(
        talg.wcc(gt), monoid=Monoid("xor", 0.0, torch.maximum,
                                    idempotent=True))
    mw = tplug.Middleware(gt, prog, daemon="blocked",
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    with pytest.raises(ValueError, match="xor"):
        mw.run(max_iterations=2)
