"""The deprecated ``GXEngine`` shim (``repro_torch/core/engine.py``)
against the JAX package's (``repro/core/engine.py``) on the same graphs,
on the CPU (``device="cpu"``): the contracts of ``tests/test_engine.py``
and ``tests/test_plug.py``'s shim tests — algorithms × shards, BSP/GAS,
the execution modes, naive mode, ``use_pallas`` (the port's
``kernel="cuda"``, on CPU tensors the kernels' plain versions), sync
skipping, lazy uploads, partitioners — the flag → component mapping, the
delegating properties, and the warning raised once; and the two graph
examples' twins at a small size.

Min programs must match JAX's engine bit for bit, sums within rtol 1e-5 /
atol 1e-6 (float32 messages added in another order); each state is also
held to the port's ``run_reference``."""
import warnings

import numpy as np
import pytest

from repro.core.balance import lemma2_fractions as jlemma2
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import GXEngine as JEngine
from repro.graph import algorithms as jalg
from repro.graph import generate as jgenerate
from repro.graph import partition as jpartition
from repro_torch import convert, plug
from repro_torch.core import engine
from repro_torch.core.engine import EngineOptions, GXEngine
from repro_torch.examples import graph_analytics, quickstart
from repro_torch.graph import algorithms as talg
from repro_torch.graph import partition as tpartition

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6

_graphs: dict = {}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _graph(kind: str, reverse: bool = False):
    """(JAX graph, port graph) — the port's carried across as arrays."""
    key = (kind, reverse)
    if key not in _graphs:
        gj = {"rmat": lambda: jgenerate.rmat(512, 4096, seed=7),
              "clustered": lambda: jgenerate.clustered(
                  600, 6000, num_clusters=4, p_cross=0.03, seed=3),
              "small": lambda: jgenerate.rmat(64, 256, seed=5),
              "shim": lambda: jgenerate.rmat(128, 1024, seed=4)}[kind]()
        if reverse:
            gj = gj.with_reverse_edges()
        _graphs[key] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[key]


def _run_both(kind, alg, max_it, *, shards=1, parts=None, **opts):
    gj, gt = _graph(kind, reverse=alg == "wcc")
    jparts, tparts = parts or (None, None)
    j = JEngine(gj, jalg.ALGORITHMS[alg](gj), partitions=jparts,
                num_shards=shards, options=JOptions(**opts))
    t = GXEngine(gt, talg.ALGORITHMS[alg](gt), partitions=tparts,
                 num_shards=shards, options=EngineOptions(**opts),
                 device="cpu")
    return j, j.run(max_iterations=max_it), t, t.run(max_iterations=max_it)


def _assert_match(alg, want, got, kind="rmat", max_it=None):
    """Port state against JAX's (min bit for bit, sums within the sum
    tolerance) and against the port's run_reference."""
    _, gt = _graph(kind, reverse=alg == "wcc")
    if alg in ("pagerank", "label_prop"):
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, want)
    ref, _ = plug.run_reference(gt, talg.ALGORITHMS[alg](gt),
                                max_iterations=max_it, device="cpu")
    fa = np.where(np.isfinite(ref), ref, 0)
    fb = np.where(np.isfinite(got), got, 0)
    np.testing.assert_allclose(fb, fa, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("alg", ["pagerank", "sssp_bf", "label_prop", "wcc",
                                 "bfs"])
@pytest.mark.parametrize("shards", [1, 4])
def test_engine_matches_jax_engine(alg, shards):
    _, jr, _, tr = _run_both("rmat", alg, 15, shards=shards, block_size=256)
    assert tr.iterations == jr.iterations
    _assert_match(alg, jr.state, tr.state, max_it=15)


@pytest.mark.parametrize("model", ["bsp", "gas"])
def test_bsp_and_gas_match_jax(model):
    j, jr, t, tr = _run_both("rmat", "sssp_bf", 50, shards=2, model=model,
                             block_size=256)
    _assert_match("sssp_bf", jr.state, tr.state, max_it=50)
    assert (tr.stats.rounds_total, tr.stats.rounds_skipped) == (
        jr.stats.rounds_total, jr.stats.rounds_skipped)


@pytest.mark.parametrize("execution", ["blocked", "pipelined", "vectorized"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_execution_modes_match_jax(execution, use_pallas):
    """Every (execution, use_pallas) pair: the port's kernel daemons on CPU
    tensors run the kernels' plain versions, JAX's its reference
    daemons (its interpret-mode Pallas path is held in
    test_use_pallas_matches_jax_pallas)."""
    gj, gt = _graph("rmat")
    j = JEngine(gj, jalg.sssp_bf(gj), num_shards=2, options=JOptions(
        execution=execution, block_size=512))
    t = GXEngine(gt, talg.sssp_bf(gt), num_shards=2, options=EngineOptions(
        execution=execution, block_size=512, use_pallas=use_pallas),
        device="cpu")
    _assert_match("sssp_bf", j.run(max_iterations=20).state,
                  t.run(max_iterations=20).state, max_it=20)
    assert t._mw.daemon.kernel == ("cuda" if use_pallas else "reference")


def test_use_pallas_matches_jax_pallas():
    j, jr, t, tr = _run_both("shim", "sssp_bf", 15, shards=2,
                             use_pallas=True, block_size=256)
    _assert_match("sssp_bf", jr.state, tr.state, kind="shim", max_it=15)
    assert isinstance(t._mw.daemon, plug.VectorizedDaemon)
    assert t._mw.daemon.csr_config == engine.CSRConfig()


def test_naive_mode_small_graph():
    j, jr, t, tr = _run_both("small", "sssp_bf", 30, execution="naive")
    _assert_match("sssp_bf", jr.state, tr.state, kind="small", max_it=30)
    assert isinstance(t._mw.daemon, plug.NaiveDaemon)


def test_sync_skipping_preserves_result_like_jax():
    """Skipping on must not change the fixed point, only the sync rounds
    (it triggers on the clustered graph), as in the JAX package."""
    runs = {}
    for skip in (True, False):
        runs[skip] = _run_both("clustered", "sssp_bf", 100, shards=4,
                               sync_skipping=skip, block_size=512)
    for skip, (j, jr, t, tr) in runs.items():
        _assert_match("sssp_bf", jr.state, tr.state, kind="clustered",
                      max_it=100)
        assert t.stats.rounds_skipped == j.stats.rounds_skipped
    assert runs[True][2].stats.rounds_skipped > 0
    assert runs[False][2].stats.rounds_skipped == 0


def test_lazy_upload_saves_bytes_like_jax():
    j, _, t, _ = _run_both("rmat", "sssp_bf", 20, shards=4, block_size=512)
    st, js = t.stats, j.stats
    assert st.lazy_bytes < st.dense_bytes
    assert st.cache_hits + st.cache_misses > 0
    assert (st.lazy_bytes, st.dense_bytes, st.cache_hits, st.cache_misses) \
        == (js.lazy_bytes, js.dense_bytes, js.cache_hits, js.cache_misses)


def test_hash_partitioner_like_jax():
    gj, gt = _graph("rmat")
    parts = (jpartition.partition_hash(gj, 4),
             tpartition.partition_hash(gt, 4))
    _, jr, _, tr = _run_both("rmat", "pagerank", 10, parts=parts,
                             block_size=256)
    _assert_match("pagerank", jr.state, tr.state, max_it=10)


def test_capacity_balanced_partitions_like_jax():
    gj, gt = _graph("rmat")
    frac = jlemma2(np.array([1.0, 1.0, 2.0, 4.0]))
    parts = (jpartition.partition_contiguous(gj, 4, fractions=frac),
             engine.partition_contiguous(gt, 4, fractions=frac))
    sizes = np.array([p.num_edges for p in parts[1]])
    assert sizes.sum() == gt.num_edges and sizes[0] > sizes[3]
    assert [p.num_edges for p in parts[0]] == sizes.tolist()
    _, jr, _, tr = _run_both("rmat", "sssp_bf", 20, parts=parts,
                             block_size=256)
    _assert_match("sssp_bf", jr.state, tr.state, max_it=20)


def test_gxengine_shim_warns_exactly_once():
    """The deprecation shim emits DeprecationWarning on first construction
    only (per process), naming the port's Middleware."""
    _, gt = _graph("shim")
    prog = talg.sssp_bf(gt)
    GXEngine._warned = False  # reset: earlier tests consumed the warning
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        GXEngine(gt, prog, options=EngineOptions(block_size=256),
                 device="cpu")
        GXEngine(gt, prog, options=EngineOptions(block_size=256),
                 device="cpu")
    dep = [w for w in seen if issubclass(w.category, DeprecationWarning)
           and "GXEngine" in str(w.message)]
    assert len(dep) == 1
    assert "repro_torch.plug.Middleware" in str(dep[0].message)


def test_shim_matches_middleware_per_execution_mode():
    """Every legacy (execution, use_pallas) flag pair maps onto a daemon
    that reproduces the same result through plug.Middleware."""
    _, g = _graph("shim")
    prog = talg.sssp_bf(g)
    ref, _ = plug.run_reference(g, prog, max_iterations=15, device="cpu")
    for execution, use_pallas, daemon in [
            ("blocked", False, "blocked"),
            ("blocked", True, plug.BlockedDaemon(kernel="cuda")),
            ("pipelined", True, plug.PipelinedDaemon(kernel="cuda")),
            ("vectorized", False, "reference"),
            ("vectorized", True, plug.VectorizedDaemon(
                kernel="cuda", csr_config=engine.CSRConfig())),
            ("naive", False, "naive")]:
        eng = GXEngine(g, prog, num_shards=1, options=EngineOptions(
            execution=execution, use_pallas=use_pallas, block_size=256),
            device="cpu")
        mw = plug.Middleware(g, prog, daemon=daemon, num_shards=1,
                             options=plug.PlugOptions(block_size=256),
                             device="cpu")
        a = eng.run(max_iterations=15).state
        b = mw.run(max_iterations=15).state
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref)


def test_delegation_and_reexports():
    _, g = _graph("shim")
    eng = GXEngine(g, talg.bfs(g), num_shards=2,
                   options=EngineOptions(execution="blocked",
                                         block_size=256), device="cpu")
    mw = eng._mw
    assert (eng.graph, eng.program, eng.partitions, eng.num_shards) == (
        mw.graph, mw.program, mw.partitions, 2)
    assert eng.blocksets is mw.blocksets and eng.stats is mw.stats
    assert (eng.block_size, eng.vblock_size) == (mw.block_size,
                                                 mw.vblock_size)
    assert eng._block_fn is mw.daemon.block_fn and eng.device.type == "cpu"
    assert engine.run_reference is plug.run_reference
    assert engine.EngineResult is plug.Result
    assert engine.partition_contiguous is tpartition.partition_contiguous
    with pytest.raises(ValueError, match="execution mode"):
        EngineOptions(execution="warp").to_daemon()


def test_examples_run_on_the_cpu():
    """The twins of examples/quickstart.py and graph_analytics.py at a
    small size, every state correct against run_reference."""
    rows = quickstart.main(["--device", "cpu", "--num-vertices", "1000",
                            "--num-edges", "8000"])
    assert [r["name"] for r in rows] == ["pagerank", "sssp-bf(4src)"]
    assert all(r["correct"] for r in rows)
    out = graph_analytics.main(["--device", "cpu", "--num-vertices", "1000",
                                "--num-edges", "7500"])
    assert out["correct"] == {"sssp_bf": True, "label_prop": True,
                              "wcc": True}
    np.testing.assert_allclose(out["rebalance_fractions"].sum(), 1.0)
