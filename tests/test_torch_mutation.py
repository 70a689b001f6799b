"""Dynamic graphs on the port (``graph/mutation.py``,
``Middleware.apply_mutations`` / ``run_dynamic``, ``MutationSchedule``
mid-run, the fused loops' mutation carries) against the JAX package's, on
the CPU.

* the batched log and its application: ``freeze``, ``apply_to_graph``,
  ``apply_to_partitions`` and ``dirty_frontier`` give JAX's arrays, dirty
  vertices and dirty shards on the same logs;
* the ``run_dynamic`` matrix {pagerank, sssp_bf, wcc} × {add, remove,
  mixed} × {bsp, async}, resident, and × bsp out of core (JAX's
  ``storage="oocore"`` axis, with the budget cut to this graph so that a
  hot block and two or three groups a shard stream): the restart mode (``dirty`` exactly for an idempotent monoid and an add-only
  batch, else ``cold_fallback``), its reason and JAX's fixed point — min
  programs bit for bit and in as many iterations, pagerank within rtol
  1e-5 / atol 1e-6;
* a batch mid-run (``MutationSchedule``) under both fused steps, a removal
  mid-run (a cold restart), vertex growth between runs (the daemon
  re-binds, so every shard's tiles are recut, as in JAX), and the tile
  counters ``tiles_recut`` / ``tilesets_reused`` against JAX's.

The fused side runs at m read from the JAX daemon, ``CSRConfig()`` pinned.
"""
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import plug as jplug  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import mutation as jmutation  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph import mutation as tmutation  # noqa: E402
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from test_torch_fused import _graph, _jax_daemon  # noqa: E402

SHARDS = 8
BLOCK = 256
CAP = 300
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ["pagerank", "sssp_bf", "wcc"]
FIELDS = ("add_src", "add_dst", "add_weights", "remove_src", "remove_dst",
          "remove_vertices")


@pytest.fixture(autouse=True)
def _pinned_config():
    autotune.CACHE.clear()
    yield
    assert autotune.CACHE.sweeps == 0


def _logs(prog_name, kind):
    """The same deterministic batch as a port and a JAX ``MutationLog``.
    wcc's graph is symmetric, so its edges go in both directions."""
    gj, _ = _graph(prog_name)
    sym = prog_name == "wcc"
    rng = np.random.default_rng(7)
    adds, removes = [], []
    if kind in ("add", "mixed"):
        for _ in range(6):
            u, v = (int(x) for x in rng.integers(0, gj.num_vertices, 2))
            adds += [(u, v)] + ([(v, u)] if sym else [])
    if kind in ("remove", "mixed"):
        for e in rng.choice(gj.num_edges, 4, replace=False):
            u, v = int(gj.src[e]), int(gj.dst[e])
            removes += [(u, v)] + ([(v, u)] if sym else [])
    logs = []
    for pkg in (tmutation, jmutation):
        log = pkg.MutationLog()
        for u, v in adds:
            log.add_edge(u, v, 1.0)
        for u, v in removes:
            log.remove_edge(u, v)
        logs.append(log)
    return logs


def _m():
    gj, _ = _graph("sssp_bf")
    return jplug.Middleware(gj, jalg.sssp_bf(gj), daemon="sharded",
                            upper="mesh", num_shards=SHARDS).daemon.m


def _pair(prog_name, model="bsp", kernel="reference", mutations=None,
          oocore=None, block=BLOCK):
    """(port, JAX) fused middlewares on the same graph; ``mutations`` is a
    pair of events lists, ``oocore`` an ``OocoreConfig``'s keywords."""
    gj, gt = _graph(prog_name)
    m = _m()
    ooc = ({} if oocore is None else
           {"oocore": (tplug.OocoreConfig(**oocore),
                       jplug.OocoreConfig(**oocore))})
    port = tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt), model=model,
        daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=block), device="cpu",
        mutations=(None if mutations is None
                   else tplug.MutationSchedule(events=mutations[0])),
        **{k: v[0] for k, v in ooc.items()})
    jax = jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon(kernel),
        upper="mesh", model=model, num_shards=SHARDS,
        options=jplug.PlugOptions(block_size=block),
        mutations=(None if mutations is None
                   else jplug.MutationSchedule(events=mutations[1])),
        **{k: v[1] for k, v in ooc.items()})
    return port, jax


def _assert_same_state(prog_name, got, want):
    if prog_name == "pagerank":
        np.testing.assert_allclose(got, np.asarray(want), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def _assert_same_partitions(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p.shard_id, p.num_vertices) == (q.shard_id, q.num_vertices)
        for f in ("src", "dst", "weights", "boundary_mask"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))


# --------------------------------------------------------------------------
# the log, the batch and their application against the JAX package
# --------------------------------------------------------------------------
def test_freeze_matches_jax_and_ignores_insertion_order():
    def build(pkg, order):
        steps = [lambda log: log.add_edge(5, 1, 2.0),
                 lambda log: log.add_edge(0, 3),
                 lambda log: log.remove_edge(9, 9),
                 lambda log: log.remove_edge(9, 9),
                 lambda log: log.add_edge(0, 3),
                 lambda log: log.add_vertex(2),
                 lambda log: log.remove_vertex(7)]
        log = pkg.MutationLog()
        for i in order:
            steps[i](log)
        return log

    a = build(tmutation, range(7)).freeze()
    b = build(tmutation, reversed(range(7))).freeze()
    c = build(jmutation, range(7)).freeze()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
    assert a.add_vertices == b.add_vertices == c.add_vertices == 2
    assert a.num_removed_edges == 1 and a.num_added_edges == 3
    np.testing.assert_array_equal(a.touched(), c.touched())
    assert (a.has_removals, a.empty) == (c.has_removals, c.empty)
    assert tmutation.MutationLog().freeze().empty
    assert len(build(tmutation, range(7))) == len(build(jmutation, range(7)))


def test_validate_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="outside"):
        tmutation.MutationLog().add_edge(0, 99).freeze().validate(10)
    tmutation.MutationLog().add_vertex().add_edge(0, 10).freeze().validate(10)
    with pytest.raises(ValueError):
        tmutation.MutationLog().add_vertex().remove_vertex(10).freeze() \
            .validate(10)
    with pytest.raises(ValueError, match="≥ 1"):
        tmutation.MutationLog().add_vertex(0)


@pytest.mark.parametrize("kind", ["add", "remove", "mixed", "grow",
                                  "tombstone"])
def test_apply_to_graph_matches_jax(kind):
    gj, gt = _graph("sssp_bf")
    if kind in ("grow", "tombstone"):
        v = int(gj.src[10])
        logs = []
        for pkg in (tmutation, jmutation):
            log = pkg.MutationLog()
            if kind == "grow":
                log.add_vertex(2).add_edge(256, 257, 3.0).add_edge(0, 256) \
                    .remove_edge(int(gj.src[0]), int(gj.dst[0]))
            else:
                log.remove_vertex(v)
            logs.append(log)
    else:
        logs = _logs("sssp_bf", kind)
    g2, dirty = tmutation.apply_to_graph(gt, logs[0])
    j2, jdirty = jmutation.apply_to_graph(gj, logs[1])
    assert g2.num_vertices == j2.num_vertices
    for f in ("src", "dst", "weights"):
        got, want = getattr(g2, f), getattr(j2, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dirty, jdirty)
    np.testing.assert_array_equal(tmutation.dirty_frontier(g2, dirty),
                                  jmutation.dirty_frontier(j2, jdirty))
    if kind == "tombstone":
        assert g2.num_vertices == gt.num_vertices
        assert not np.any(g2.src == v) and not np.any(g2.dst == v)


@pytest.mark.parametrize("kind", ["add", "remove", "mixed", "shard3"])
def test_apply_to_partitions_matches_jax(kind):
    """The same partitions, dirty shards and dirty vertices as JAX's; a
    clean shard's edge arrays are reused by reference."""
    port, jax = _pair("sssp_bf")
    if kind == "shard3":
        src0 = int(port.partitions[3].src[0])
        logs = [pkg.MutationLog().add_edge(src0, 5)
                for pkg in (tmutation, jmutation)]
    else:
        logs = _logs("sssp_bf", kind)
    g2, parts, shards, dirty = tmutation.apply_to_partitions(
        port.graph, port.partitions, logs[0])
    j2, jparts, jshards, jdirty = jmutation.apply_to_partitions(
        jax.graph, jax.partitions, logs[1])
    _assert_same_partitions(parts, jparts)
    assert shards == jshards
    np.testing.assert_array_equal(dirty, jdirty)
    assert sum(p.num_edges for p in parts) == g2.num_edges
    if kind == "shard3":
        assert shards == [3]
    for j, (old, new) in enumerate(zip(port.partitions, parts)):
        if j not in shards:
            assert new.src is old.src and new.dst is old.dst


def test_dirty_frontier_is_touched_plus_out_neighbours():
    g = Graph(num_vertices=5, src=np.array([0, 1, 2], np.int32),
              dst=np.array([1, 2, 3], np.int32))
    np.testing.assert_array_equal(tmutation.dirty_frontier(g, [1]),
                                  [False, True, True, False, False])


def test_schedule_rejects_vertex_adds_and_needs_a_fused_loop():
    with pytest.raises(ValueError, match="cannot add vertices"):
        tmutation.MutationSchedule(events=[(1, tmutation.MutationLog()
                                            .add_vertex())])
    sched = tmutation.MutationSchedule(events=[
        (3, tmutation.MutationLog().add_edge(0, 1)),
        (1, tmutation.MutationLog())])
    assert [len(sched.due_at(i)) for i in (0, 1, 2, 5)] == [0, 1, 0, 1]
    assert sched.exhausted
    sched.reset()
    assert not sched.exhausted
    _, gt = _graph("sssp_bf")
    with pytest.raises(ValueError, match="fused"):
        tplug.Middleware(gt, talg.sssp_bf(gt), daemon="vectorized",
                         upper="host", num_shards=4, device="cpu",
                         mutations=tmutation.MutationSchedule(events=[]))


# --------------------------------------------------------------------------
# run_dynamic: incremental where sound, cold elsewhere, JAX's answer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["bsp", "async"])
@pytest.mark.parametrize("kind", ["add", "remove", "mixed"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_run_dynamic_matrix_matches_jax(prog_name, kind, model):
    port, jax = _pair(prog_name, model)
    assert port.run(max_iterations=CAP).converged
    jax.run(max_iterations=CAP)
    tlog, jlog = _logs(prog_name, kind)
    res = port.run_dynamic(tlog, max_iterations=CAP)
    want = jax.run_dynamic(jlog, max_iterations=CAP)
    assert res.converged and port.epochs.epoch.cause == "mutation"
    sound = port.program.monoid.idempotent and kind == "add"
    got_r, want_r = port.last_restart, jax.last_restart
    assert got_r["mode"] == want_r["mode"] == ("dirty" if sound
                                               else "cold_fallback")
    for key in ("incremental", "reason", "dirty_count"):
        assert got_r[key] == want_r[key], key
    if prog_name != "pagerank":
        assert got_r["iterations"] == want_r["iterations"]
        assert res.iterations == want.iterations
    _assert_same_partitions(port.partitions, jax.partitions)
    _assert_same_state(prog_name, res.state, want.state)
    g2, _ = tmutation.apply_to_graph(_graph(prog_name)[1], tlog.freeze())
    ref, _ = tplug.run_reference(g2, talg.ALGORITHMS[prog_name](g2),
                                 max_iterations=CAP, device="cpu")
    _assert_same_state(prog_name, res.state, ref)


# tests/test_mutation.py's oocore budget is 60,000 bytes on its graph; on
# this one at 64-edge blocks 8,000 keeps one block a shard hot and streams
# the rest in two or three groups
OOCORE = dict(hbm_budget=8_000, hot_fraction=0.3)
OOCORE_BLOCK = 64


@pytest.mark.parametrize("kind", ["add", "remove", "mixed"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_run_dynamic_out_of_core_matches_jax(prog_name, kind):
    """tests/test_mutation.py's ``storage="oocore"`` axis (BSP only: the
    async model does not stream): the mutation epoch re-plans the
    super-shards, and the restart gives JAX's mode and fixed point and
    run_reference's."""
    port, jax = _pair(prog_name, oocore=OOCORE, block=OOCORE_BLOCK)
    assert isinstance(port._loop, tplug.OocoreDriveLoop)
    assert port.daemon.num_super_shards == jax.daemon.num_super_shards > 0
    assert port.run(max_iterations=CAP).converged
    jax.run(max_iterations=CAP)
    tlog, jlog = _logs(prog_name, kind)
    res = port.run_dynamic(tlog, max_iterations=CAP)
    want = jax.run_dynamic(jlog, max_iterations=CAP)
    assert res.converged and port.epochs.epoch.cause == "mutation"
    assert port.epochs.epoch.oocore_plan is port.daemon.oocore_plan
    sound = port.program.monoid.idempotent and kind == "add"
    got_r, want_r = port.last_restart, jax.last_restart
    assert got_r["mode"] == want_r["mode"] == ("dirty" if sound
                                               else "cold_fallback")
    for key in ("incremental", "reason", "dirty_count"):
        assert got_r[key] == want_r[key], key
    if prog_name != "pagerank":
        assert res.iterations == want.iterations
        assert [r["oocore"]["skipped"] for r in res.per_iteration] == \
            [r["oocore"]["skipped"] for r in want.per_iteration]
    _assert_same_state(prog_name, res.state, want.state)
    g2, _ = tmutation.apply_to_graph(_graph(prog_name)[1], tlog.freeze())
    ref, _ = tplug.run_reference(g2, talg.ALGORITHMS[prog_name](g2),
                                 max_iterations=CAP, device="cpu")
    _assert_same_state(prog_name, res.state, ref)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_mid_run_batch_out_of_core_matches_jax(kernel):
    """An add batch before iteration 3 of an out-of-core sssp_bf: the run
    continues incrementally over the re-planned super-shards to JAX's
    fixed point, in as many iterations."""
    tlog, jlog = _logs("sssp_bf", "add")
    port, jax = _pair("sssp_bf", kernel=kernel, oocore=OOCORE,
                      block=OOCORE_BLOCK,
                      mutations=([(3, tlog)], [(3, jlog)]))
    res = port.run(max_iterations=CAP)
    want = jax.run(max_iterations=CAP)
    assert res.converged and res.iterations == want.iterations
    (mut,) = [r["mutation"] for r in res.per_iteration if "mutation" in r]
    assert mut["incremental"] and "mutation" in res.per_iteration[2]
    for a, b in zip(res.per_iteration, want.per_iteration):
        assert a["active"] == b["active"], a["iteration"]
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    ref, _ = tplug.run_reference(port.graph, talg.sssp_bf(port.graph),
                                 device="cpu")
    np.testing.assert_array_equal(res.state, ref)


def test_incremental_restart_takes_fewer_iterations():
    port, _ = _pair("sssp_bf")
    cold = port.run().iterations
    res = port.run_dynamic(tmutation.MutationLog().add_edge(3, 77, 1.0))
    assert port.last_restart["mode"] == "dirty"
    assert res.iterations < cold


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_vertex_growth_between_runs_matches_jax(kernel):
    """Three vertices join between runs: the daemon and the upper re-bind
    to the new n, which drops every compacted tileset — all shards are
    recut, as in JAX — and the grown fixed point is JAX's."""
    port, jax = _pair("sssp_bf", kernel=kernel)
    port.run()
    jax.run()
    recut = [d.tiles_recut for d in (port.daemon, jax.daemon)]
    logs = [pkg.MutationLog().add_vertex(3).add_edge(0, 256)
            .add_edge(256, 257) for pkg in (tmutation, jmutation)]
    res = port.run_dynamic(logs[0])
    want = jax.run_dynamic(logs[1])
    assert port.n == 259 and res.state.shape == (259, 4)
    assert port.last_restart["mode"] == jax.last_restart["mode"] == "dirty"
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    if kernel == "cuda":
        assert [d.tiles_recut - r for d, r in zip(
            (port.daemon, jax.daemon), recut)] == [SHARDS, SHARDS]


# --------------------------------------------------------------------------
# mid-run batches
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("model", ["bsp", "async"])
def test_mid_run_batch_matches_jax(model, kernel):
    """An add batch lands before iteration 3 of a running sssp_bf: the
    run continues incrementally to the mutated graph's fixed point, with
    JAX's records and iterations."""
    tlog, jlog = _logs("sssp_bf", "add")
    port, jax = _pair("sssp_bf", model, kernel,
                      mutations=([(3, tlog)], [(3, jlog)]))
    res = port.run(max_iterations=CAP)
    want = jax.run(max_iterations=CAP)
    assert res.converged and port.mutations.exhausted
    assert res.iterations == want.iterations
    got = [r["mutation"] for r in res.per_iteration if "mutation" in r]
    exp = [r["mutation"] for r in want.per_iteration if "mutation" in r]
    assert len(got) == len(exp) == 1 and "mutation" in res.per_iteration[2]
    for key in ("batches", "edges_added", "edges_removed",
                "dirty_vertices", "incremental"):
        assert got[0][key] == exp[0][key], key
    assert got[0]["incremental"] and got[0]["seconds"] >= 0.0
    for a, b in zip(res.per_iteration, want.per_iteration):
        assert a["active"] == b["active"], a["iteration"]
        if kernel == "reference":
            assert a["shard_blocks_run"] == b["shard_blocks_run"]
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    g2 = port.graph  # the mutated graph
    ref, _ = tplug.run_reference(g2, talg.sssp_bf(g2), device="cpu")
    np.testing.assert_array_equal(res.state, ref)


@pytest.mark.parametrize("model", ["bsp", "async"])
def test_mid_run_removal_restarts_cold_and_stays_exact(model):
    tlog, jlog = _logs("sssp_bf", "remove")
    port, jax = _pair("sssp_bf", model,
                      mutations=([(4, tlog)], [(4, jlog)]))
    res = port.run(max_iterations=CAP)
    want = jax.run(max_iterations=CAP)
    (mut,) = [r["mutation"] for r in res.per_iteration if "mutation" in r]
    assert not mut["incremental"]
    assert res.converged and res.iterations == want.iterations
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


def test_mid_run_batch_moves_no_vertex_sized_tensor_to_the_host(monkeypatch):
    """A BSP batch mid-run keeps the iteration's one small fetch: the new
    aux and frontier go to the device, nothing vertex-sized comes back."""
    import torch

    tlog, _ = _logs("sssp_bf", "add")
    port, _ = _pair("sssp_bf", kernel="cuda",
                    mutations=([(3, tlog)], []))
    calls = []
    for name in ("cpu", "tolist", "item", "__bool__", "__int__"):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, _n=name, _o=orig, **kw):
            calls.append((_n, self.numel()))
            return _o(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapper)
    res = port.run(max_iterations=CAP)
    n = port.n
    assert [c for c in calls if c[1] >= n] == [("cpu", n * port.k)]
    assert [c[0] for c in calls if c[1] < n] == ["tolist"] * res.iterations


@pytest.mark.parametrize("when", ["between", "mid-run"])
def test_dirty_shard_recut_counters_match_jax(when):
    """A batch whose sources all own edges in shard 2 recuts that shard
    alone: ``tiles_recut`` + 1 and ``tilesets_reused`` + 7, the counters of
    JAX's daemon, and the answer is exact."""
    gj, gt = _graph("sssp_bf")
    probe, _ = _pair("sssp_bf")
    src = [int(s) for s in np.unique(probe.partitions[2].src)[:3]]
    logs = []
    for pkg in (tmutation, jmutation):
        log = pkg.MutationLog()
        for i, s in enumerate(src):
            log.add_edge(s, (s * 7 + i) % gt.num_vertices, 0.25)
        logs.append(log)
    sched = ([(2, logs[0])], [(2, logs[1])]) if when == "mid-run" else None
    port, jax = _pair("sssp_bf", kernel="cuda", mutations=sched)
    base = [(d.tiles_recut, d.tilesets_reused)
            for d in (port.daemon, jax.daemon)]
    if when == "mid-run":
        res, want = port.run(), jax.run()
    else:
        ep = port.apply_mutations(logs[0])
        jep = jax.apply_mutations(logs[1])
        assert ep.meta["shards_recut"] == jep.meta["shards_recut"] == 1
        res, want = port.run(), jax.run()
    deltas = [(d.tiles_recut - r, d.tilesets_reused - u)
              for d, (r, u) in zip((port.daemon, jax.daemon), base)]
    assert deltas[0] == deltas[1] == (1, SHARDS - 1)
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    g2, _ = tmutation.apply_to_graph(gt, logs[0].freeze())
    np.testing.assert_array_equal(res.state, tplug.run_reference(
        g2, talg.sssp_bf(g2), device="cpu")[0])


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_vertex_block_overflow_widens_instead_of_rebuilding(kernel):
    """300 edges from shard 2's sources to uniform destinations outgrow the
    pinned vertex-block width.  JAX rebuilds every shard then; the port
    rebuilds shard 2 and pads the others' vertex blocks to the new width:
    every block array equals JAX's, the clean shards' tiles are kept (1
    recut, 7 reused against JAX's 8 and 0), and the fixed point is JAX's."""
    port, jax = _pair("sssp_bf", kernel=kernel)
    rng = np.random.default_rng(3)
    src = rng.choice(np.unique(port.partitions[2].src), 300)
    dst = rng.integers(0, port.n, 300)
    logs = []
    for pkg in (tmutation, jmutation):
        log = pkg.MutationLog()
        for s, d in zip(src.tolist(), dst.tolist()):
            log.add_edge(s, d, 0.5)
        logs.append(log)
    width = port.vblock_size
    base = [(d.tiles_recut, d.tilesets_reused)
            for d in (port.daemon, jax.daemon)]
    kept = [port.blocksets[j].gsrc for j in range(SHARDS)]
    ep, jep = port.apply_mutations(logs[0]), jax.apply_mutations(logs[1])
    assert jep.meta["shards_recut"] == SHARDS  # JAX's rebuild of all
    assert ep.meta["shards_recut"] == 1 and ep.meta["shards_clean"] == 7
    assert port.vblock_size == jax.vblock_size > width
    for j, (a, b) in enumerate(zip(port.blocksets, jax.blocksets)):
        assert a.vblock_size == b.vblock_size == port.vblock_size
        for f in ("vids", "vmask", "lsrc", "ldst", "weights", "emask",
                  "gsrc", "gdst"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.gsrc is kept[j]) == (j != 2)  # clean edges kept
    if kernel == "cuda":
        assert [(d.tiles_recut - r, d.tilesets_reused - u) for d, (r, u)
                in zip((port.daemon, jax.daemon), base)] == [(1, 7), (8, 0)]
    np.testing.assert_array_equal(port.run().state,
                                  np.asarray(jax.run().state))


def test_widen_vblocks_is_build_blocks_at_the_wider_width():
    from repro_torch.core.blocks import build_blocks, widen_vblocks

    port, _ = _pair("sssp_bf")
    part = port.partitions[0]
    narrow = build_blocks(part, BLOCK)
    wide = widen_vblocks(narrow, narrow.vblock_size + 40)
    want = build_blocks(part, BLOCK, vblock_size=narrow.vblock_size + 40)
    for f in ("vids", "vmask", "lsrc", "ldst", "weights", "emask", "gsrc",
              "gdst"):
        np.testing.assert_array_equal(getattr(wide, f), getattr(want, f))
    assert wide.gsrc is narrow.gsrc
    assert widen_vblocks(narrow, narrow.vblock_size) is narrow
    with pytest.raises(ValueError, match="narrow"):
        widen_vblocks(narrow, narrow.vblock_size - 8)
