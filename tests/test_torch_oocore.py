"""Out-of-core execution on the port (``repro_torch.oocore``,
``ShardedDaemon.bind_super_shards``, ``OocoreDriveLoop``,
``dist.fault.oocore_replan``, ``Middleware.oocore_replan``) against the JAX
package's, on the CPU — each of tests/test_oocore.py's contracts:

* the config's validation and the planner's arithmetic (budget split, the
  degenerate budgets, the smaller-axis re-plan), ``super_shard_cuts``,
  ``tile_access_scores`` and ``take_tiles`` equal to JAX's;
  ``build_super_shards`` with JAX's order, hot and cold stacks and cold
  sources for the same fields;
* the bit-identity matrix (hot fraction × group count × prefetch): states,
  iterations and every record's ``super_shards``, ``hot_cols``,
  ``skipped``, ``hot_hits`` and ``cold_misses`` equal to JAX's
  ``OocoreDriveLoop``, and the state equal to the port's resident run;
  the byte budget (the port's plan from what its fields weigh, JAX's
  planner on the same numbers), prefetch as an overlay, sums within rtol
  1e-5 / atol 1e-6, the CSR kernel (its plain twin at ``CSRConfig()``
  against JAX's Pallas tile in interpret mode), a mid-run kill, the
  hit/miss/overlap counters, frontier skipping on ``grid_road(48)``,
  no-prefetch's zero overlap, and the refused compositions;
* on the port alone: the uploader's interface on the CPU (at most two
  groups live), ``run_all_shards`` on a group that carries only its own
  fields, one small fetch an iteration, the re-plan epoch.

The JAX side runs 8 shards at whatever m its process's CPU devices give it
(``XLA_FLAGS`` asks for 8 when this module is the first to start JAX); the
port gets ``mesh=m`` read from the JAX daemon.  Every port test pins
``CSRConfig()``, and a fixture checks that nothing swept.

Where the two packages differ by design: the port's CSR column streams the
seven fields its shard body reads (JAX streams all eight tile fields), so
its byte plans are compared with JAX's planner given the same
``(num_cols, col_bytes)`` and trajectories use ``num_super_shards=``; and
after a structure epoch the port takes every group for one iteration
(the group verdicts ride the step's fetch), where JAX reads the frontier
back.
"""
import dataclasses
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import oocore as joocore  # noqa: E402
from repro import plug as jplug  # noqa: E402
from repro.dist import fault as jfault  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import compaction as jcompaction  # noqa: E402
from repro.graph import generate as jgenerate  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import oocore as toocore  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.dist import fault as tfault  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph import compaction as tcompaction  # noqa: E402
from repro_torch.graph import partition as tpartition  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from test_torch_fused import _jax_daemon  # noqa: E402

SHARDS = 8
BLOCK = 128
MAX_IT = 12
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
# the per-iteration oocore counters both packages must agree on
COUNTERS = ("super_shards", "hot_cols", "prefetch", "skipped", "hot_hits",
            "cold_misses")

_graphs: dict = {}
_m: list = []


@pytest.fixture(autouse=True)
def _pinned_config():
    autotune.CACHE.clear()
    yield
    assert autotune.CACHE.sweeps == 0


def _graph(key="rmat"):
    """(JAX graph, port graph): test_oocore.py's R-MAT, a denser one with
    several CSR tiles a shard, and its road lattice."""
    if key not in _graphs:
        gj = {"rmat": lambda: jgenerate.rmat(512, 4096, seed=7),
              "dense": lambda: jgenerate.rmat(512, 16384, seed=7),
              "road": lambda: jgenerate.grid_road(48, seed=3)}[key]()
        _graphs[key] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[key]


def _mesh():
    """JAX's m for 8 shards on this process's CPU devices."""
    if not _m:
        gj, _ = _graph()
        _m.append(jplug.Middleware(gj, jalg.sssp_bf(gj), daemon="sharded",
                                   upper="mesh",
                                   num_shards=SHARDS).daemon.m)
    return _m[0]


def _port(prog_name="sssp_bf", *, oocore=None, kernel="reference",
          key="rmat", **kw):
    _, gt = _graph(key)
    m = _mesh()
    return tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt),
        daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        oocore=None if oocore is None else tplug.OocoreConfig(**oocore),
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu", **kw)


def _jax(prog_name="sssp_bf", *, oocore=None, kernel="reference",
         key="rmat", **kw):
    gj, _ = _graph(key)
    return jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon(kernel),
        upper="mesh", num_shards=SHARDS,
        oocore=None if oocore is None else jplug.OocoreConfig(**oocore),
        options=jplug.PlugOptions(block_size=BLOCK), **kw)


def _records(res):
    return [{k: r["oocore"][k] for k in COUNTERS} for r in res.per_iteration]


def _assert_same_run(res, want, *, sums=False):
    assert res.iterations == want.iterations
    assert res.converged == want.converged
    if sums:
        np.testing.assert_allclose(res.state, np.asarray(want.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(res.state, np.asarray(want.state))


@pytest.fixture(scope="module")
def resident_sssp():
    return _port().run(max_iterations=MAX_IT)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    {}, {"hbm_budget": 1 << 20, "num_super_shards": 2},
    {"hbm_budget": 1 << 20, "hot_fraction": 1.5},
    {"hbm_budget": -1}, {"num_super_shards": 0},
    {"hbm_budget": 1 << 20, "hot_fraction": -0.1}])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as got:
        toocore.OocoreConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        joocore.OocoreConfig(**kwargs)
    assert str(got.value) == str(want.value)
    ok = toocore.OocoreConfig(hbm_budget=4096)
    assert dataclasses.asdict(ok) == dataclasses.asdict(
        joocore.OocoreConfig(hbm_budget=4096))


def _plan_cases(seed, count=60):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(count):
        num_cols = int(rng.integers(0, 300))
        col_bytes = int(rng.integers(0, 5000))
        hot = float(rng.choice([0.0, 0.25, 0.3, 0.5, 1.0, rng.random()]))
        if rng.random() < 0.5:
            cfg = dict(hbm_budget=int(rng.integers(0, 400_000)),
                       hot_fraction=hot)
        else:
            cfg = dict(num_super_shards=int(rng.integers(1, 12)),
                       hot_fraction=hot)
        cases.append((num_cols, col_bytes, cfg))
    return cases


@pytest.mark.parametrize("seed", range(3))
def test_plan_arithmetic_matches_jax(seed):
    """Random (num_cols, col_bytes, config) triples — budget and explicit
    splits — plan to JAX's plan field for field, with its properties."""
    for num_cols, col_bytes, cfg in _plan_cases(seed):
        got = toocore.plan_super_shards(num_cols, col_bytes,
                                        toocore.OocoreConfig(**cfg))
        want = joocore.plan_super_shards(num_cols, col_bytes,
                                         joocore.OocoreConfig(**cfg))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), cfg
        for prop in ("cold_cols", "resident_bytes_dev",
                     "super_shard_bytes_dev"):
            assert getattr(got, prop) == getattr(want, prop), prop


def test_plan_budget_arithmetic_and_degenerate_budgets():
    """test_oocore.py's worked cases on the port's planner."""
    plan = toocore.plan_super_shards(
        100, 10, toocore.OocoreConfig(hbm_budget=800, hot_fraction=0.5))
    assert (plan.hot_cols, plan.cols_per_super_shard,
            plan.num_super_shards, plan.fits_resident) == (40, 20, 3, False)
    assert plan.resident_bytes_dev <= 800
    tight = toocore.plan_super_shards(
        100, 10, toocore.OocoreConfig(hbm_budget=0, hot_fraction=0.0))
    assert (tight.hot_cols, tight.cols_per_super_shard,
            tight.num_super_shards) == (0, 1, 100)
    full = toocore.plan_super_shards(
        100, 10, toocore.OocoreConfig(hbm_budget=10_000, hot_fraction=1.0))
    assert (full.hot_cols, full.num_super_shards, full.fits_resident) == \
        (100, 0, True)


@pytest.mark.parametrize("mesh", [8, 4, 2, 1])
def test_oocore_replan_matches_jax(mesh):
    """A shorter axis raises a column's per-device bytes, so the same
    budget buys a finer split — the plan equal to JAX's at every m."""
    cfg = dict(hbm_budget=4096, hot_fraction=0.25)
    got = tfault.oocore_replan(64, 16, 8, mesh, toocore.OocoreConfig(**cfg))
    want = jfault.oocore_replan(64, 16, 8, mesh,
                                joocore.OocoreConfig(**cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.col_bytes_dev == 16 * (8 // mesh)
    if mesh == 4:
        before = tfault.oocore_replan(64, 16, 8, 8,
                                      toocore.OocoreConfig(**cfg))
        assert got.col_bytes_dev == 2 * before.col_bytes_dev
        assert got.num_super_shards > before.num_super_shards
        assert got.hot_cols < before.hot_cols
    with pytest.raises(ValueError, match="divisible"):
        tfault.oocore_replan(64, 16, 8, 3, toocore.OocoreConfig(**cfg))


def test_super_shard_cuts_match_jax():
    for num_cols in range(0, 13):
        for hot in range(0, num_cols + 1):
            for per in range(1, 6):
                assert tpartition.super_shard_cuts(num_cols, hot, per) == \
                    jpartition.super_shard_cuts(num_cols, hot, per)
    assert tpartition.super_shard_cuts(10, 10, 0) == (slice(0, 10), [])
    for args in ((10, 11, 2), (10, 4, 0)):
        with pytest.raises(ValueError):
            tpartition.super_shard_cuts(*args)
        with pytest.raises(ValueError):
            jpartition.super_shard_cuts(*args)


def test_tile_access_scores_and_take_tiles_match_jax():
    gj, gt = _graph()
    ts = tcompaction.build_csr_tiles(gt.src, gt.dst, gt.weights,
                                     gt.num_vertices, edge_tile=256)
    js = jcompaction.build_csr_tiles(gj.src, gj.dst, gj.weights,
                                     gj.num_vertices, edge_tile=256)
    deg = np.bincount(gt.src, minlength=gt.num_vertices)
    scores = tcompaction.tile_access_scores(ts.gsrc, ts.emask, deg)
    want = jcompaction.tile_access_scores(js.gsrc, js.emask, deg)
    assert scores.dtype == want.dtype
    np.testing.assert_array_equal(scores, want)
    assert scores.shape == (ts.num_tiles,) and scores.sum() > 0
    order = np.argsort(-scores, kind="stable")
    got, exp = tcompaction.take_tiles(ts, order), jcompaction.take_tiles(
        js, order)
    assert got.num_tiles == exp.num_tiles == ts.num_tiles
    for f in ("rows", "seg", "lsrc", "svids", "w", "emask", "gsrc", "gdst",
              "eblock"):
        a, b = getattr(got, f), getattr(exp, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.emask.sum() == ts.emask.sum()
    sel = tcompaction.take_tiles(ts, order[:3])
    assert sel.num_tiles == 3


@pytest.mark.parametrize("plan", [
    dict(num_super_shards=3, hot_fraction=0.3),
    dict(num_super_shards=2, hot_fraction=0.0),
    dict(hbm_budget=20_000, hot_fraction=0.25)])
def test_build_super_shards_matches_jax(plan):
    """The same stacked fields and scores cut into JAX's order, hot stack,
    padded cold stacks and cold sources."""
    mw = _port(kernel="cuda")
    fields = mw.daemon._stack_csr_tiles(mw.blocksets, lambda name, a: a)
    deg = np.bincount(fields["gsrc"][fields["emask"]].ravel(),
                      minlength=mw.n)
    scores = tcompaction.tile_access_scores(fields["gsrc"], fields["emask"],
                                            deg)
    p = toocore.plan_super_shards(scores.shape[1], 1000,
                                  toocore.OocoreConfig(**plan))
    jp = joocore.plan_super_shards(scores.shape[1], 1000,
                                   joocore.OocoreConfig(**plan))
    got = toocore.build_super_shards(fields, scores, p)
    want = joocore.build_super_shards(fields, scores, jp)
    np.testing.assert_array_equal(got.order, want.order)
    assert got.num_super_shards == want.num_super_shards
    assert got.super_shard_nbytes == want.super_shard_nbytes
    assert (got.hot_host is None) == (want.hot_host is None)
    for a, b in ([(got.hot_host, want.hot_host)] if got.hot_host else []) \
            + list(zip(got.cold_hosts, want.cold_hosts)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(got.cold_srcs, want.cold_srcs):
        np.testing.assert_array_equal(a, b)
    srcs, group = got.source_index()
    assert srcs.size == group.size == sum(a.size for a in got.cold_srcs)


# --------------------------------------------------------------------------
# bit-identity against JAX's out-of-core loop and the resident run
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hot_fraction,num_ss,prefetch", [
    (0.0, 2, True),    # pure streaming, double-buffered
    (0.0, 3, False),   # pure streaming, serialized baseline
    (0.5, 2, False),   # cache + stream
    (0.5, 3, True),
    (1.0, 1, True),    # everything hot: nothing streams
])
def test_bit_identity_matrix_matches_jax(resident_sssp, hot_fraction, num_ss,
                                         prefetch):
    oc = dict(num_super_shards=num_ss, hot_fraction=hot_fraction,
              prefetch=prefetch)
    mw = _port(oocore=oc)
    assert isinstance(mw._loop, tplug.OocoreDriveLoop)
    res = mw.run(max_iterations=MAX_IT)
    want = _jax(oocore=oc).run(max_iterations=MAX_IT)
    _assert_same_run(res, want)
    _assert_same_run(res, resident_sssp)
    assert _records(res) == _records(want)
    for r, w in zip(res.per_iteration, want.per_iteration):
        assert r["shard_blocks_run"] == w["shard_blocks_run"]


def test_bit_identity_under_byte_budget(resident_sssp):
    """A budget of a third of the resident column bytes: the port's plan is
    JAX's planner on the port's own column weight, the run still exact."""
    probe = _port()
    st = probe.daemon.stacked
    total_dev = sum(t.numel() * t.element_size() for t in st.values()
                    ) // probe.daemon.m
    oc = dict(hbm_budget=total_dev // 3, hot_fraction=0.25)
    mw = _port(oocore=oc)
    plan = mw.daemon.oocore_plan
    assert plan.fits_resident is False and plan.num_super_shards > 0
    col_bytes = sum(t[0, 0].numel() * t.element_size() for t in st.values())
    assert plan.col_bytes_dev == col_bytes * (SHARDS // mw.daemon.m)
    want_plan = joocore.plan_super_shards(
        plan.num_cols, plan.col_bytes_dev, joocore.OocoreConfig(**oc))
    assert dataclasses.asdict(plan) == dataclasses.asdict(want_plan)
    # the block stacks weigh what JAX's do: the same plan, the same run
    jmw = _jax(oocore=oc)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jmw.daemon.oocore_plan)
    res = mw.run(max_iterations=MAX_IT)
    _assert_same_run(res, resident_sssp)
    assert _records(res) == _records(jmw.run(max_iterations=MAX_IT))


def test_prefetch_schedule_deterministic():
    """Prefetch is an overlay, not a schedule change: two prefetching runs
    and a serialized one give the same bits."""
    def run(pf):
        return _port(oocore=dict(num_super_shards=3, hot_fraction=0.3,
                                 prefetch=pf)).run(max_iterations=MAX_IT)

    a, b, c = run(True), run(True), run(False)
    np.testing.assert_array_equal(a.state, b.state)
    np.testing.assert_array_equal(a.state, c.state)
    assert _records(a) == _records(b)


@pytest.mark.parametrize("prog_name", ["pagerank", "label_prop"])
def test_sum_monoid_matches_to_float_tolerance(prog_name):
    """A sum accumulates the groups in plan order: the port matches JAX's
    out-of-core run and its own resident run within tolerance."""
    oc = dict(num_super_shards=3, hot_fraction=0.25)
    res = _port(prog_name, oocore=oc).run(max_iterations=5)
    _assert_same_run(res, _jax(prog_name, oocore=oc).run(max_iterations=5),
                     sums=True)
    _assert_same_run(res, _port(prog_name).run(max_iterations=5), sums=True)
    assert _records(res) == _records(
        _jax(prog_name, oocore=oc).run(max_iterations=5))


@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_kernel_streams_csr_tiles(prefetch):
    """``kernel="cuda"`` streams stacked CSR tiles (only the fields its
    body reads) — the same tile-aligned cuts and the same bits as JAX's
    Pallas tile and the port's resident kernel run."""
    oc = dict(num_super_shards=2, hot_fraction=0.5, prefetch=prefetch)
    mw = _port(oocore=oc, kernel="cuda", key="dense")
    assert set(mw.daemon.hot_stacked) == {"csr"}
    assert "gdst" not in mw.daemon.hot_stacked["csr"]
    res = mw.run()
    want = _jax(oocore=oc, kernel="cuda", key="dense").run()
    _assert_same_run(res, want)
    _assert_same_run(res, _port(kernel="cuda", key="dense").run())
    assert _records(res) == _records(want)
    assert any(r["oocore"]["cold_misses"] for r in res.per_iteration)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_bit_identity_across_midrun_kill(kernel):
    """A device killed before iteration 3 re-plans the super-shards for the
    survivor axis (a column's per-device bytes double), and the answer is
    still the uninterrupted resident run's and JAX's, bit for bit.  The
    records agree but for the iteration after the re-cut, where the port
    takes every group."""
    oc = dict(num_super_shards=3, hot_fraction=0.3)
    kill = tplug.FailureSchedule(kills=[(3, 2)])
    mw = _port(oocore=oc, kernel=kernel, failures=kill)
    jmw = _jax(oocore=oc, kernel=kernel,
               failures=jplug.FailureSchedule(kills=[(3, 2)]))
    before = mw.daemon.oocore_plan.col_bytes_dev
    res, want = mw.run(max_iterations=MAX_IT), jmw.run(max_iterations=MAX_IT)
    _assert_same_run(res, want)
    _assert_same_run(res, _port(kernel=kernel).run(max_iterations=MAX_IT))
    migs = [r["migration"] for r in res.per_iteration if "migration" in r]
    assert len(migs) == 1 and "migration" in res.per_iteration[2]
    assert mw.daemon.oocore_plan.col_bytes_dev == 2 * before
    assert mw.daemon.m == jmw.daemon.m == _mesh() // 2
    assert dataclasses.asdict(mw.daemon.oocore_plan)["num_super_shards"] == \
        jmw.daemon.oocore_plan.num_super_shards
    got, exp = _records(res), _records(want)
    assert got[2]["skipped"] == 0
    for i, (a, b) in enumerate(zip(got, exp)):
        if i == 2:
            a, b = dict(a, skipped=0), dict(b, skipped=0)
        assert a == b, i
    assert mw.epochs.epoch.oocore_plan is mw.daemon.oocore_plan


# --------------------------------------------------------------------------
# the counters
# --------------------------------------------------------------------------
def test_hit_miss_and_overlap_counters_match_jax():
    oc = dict(num_super_shards=2, hot_fraction=0.5)
    mw = _port("pagerank", oocore=oc)
    res = mw.run(max_iterations=4)
    jmw = _jax("pagerank", oocore=oc)
    want = jmw.run(max_iterations=4)
    st, jst = mw.oocore_stats, jmw.oocore_stats
    assert set(st) == set(jst) | {"max_live_groups"}
    for key in ("iterations", "hot_hits", "cold_misses", "uploads",
                "upload_bytes", "skipped", "super_shards", "prefetch",
                "hot_hit_rate"):
        assert st[key] == jst[key], key
    assert st["iterations"] == res.iterations
    assert st["hot_hits"] > 0 and st["cold_misses"] > 0
    assert 0.0 < st["hot_hit_rate"] < 1.0
    assert 0.0 <= st["overlap_efficiency"] <= 1.0
    assert st["uploads"] == st["iterations"] * mw.daemon.num_super_shards
    assert st["upload_bytes"] == st["uploads"] * mw.daemon.super_shard_nbytes
    assert 1 <= st["max_live_groups"] <= 2
    for r, w in zip(res.per_iteration, want.per_iteration):
        oc_rec = r["oocore"]
        assert set(oc_rec) == set(w["oocore"])
        assert 0.0 <= oc_rec["overlap_efficiency"] <= 1.0
        assert oc_rec["hot_hits"] + oc_rec["cold_misses"] == r["blocks_run"]
        assert oc_rec["transfer_s"] >= 0.0 and oc_rec["seconds"] > 0.0


def test_frontier_skipping_counters_and_identity():
    """On a wavefront (the road lattice) the scheduler skips the groups the
    frontier never touches — JAX's decisions, iteration for iteration — and
    the skips are free: the answer is the resident run's.  Without prefetch
    nothing is skipped."""
    oc = dict(num_super_shards=6, hot_fraction=0.0)
    ref = _port(key="road").run(max_iterations=10)
    mw = _port(oocore=oc, key="road")
    res = mw.run(max_iterations=10)
    want = _jax(oocore=oc, key="road").run(max_iterations=10)
    _assert_same_run(res, ref)
    _assert_same_run(res, want)
    assert _records(res) == _records(want)
    st = mw.oocore_stats
    assert st["skipped"] > 0
    assert (st["uploads"] + st["skipped"]
            == st["iterations"] * mw.daemon.num_super_shards)
    npf = _port(oocore=dict(oc, prefetch=False), key="road")
    _assert_same_run(npf.run(max_iterations=10), ref)
    assert npf.oocore_stats["skipped"] == 0


def test_noprefetch_has_zero_overlap():
    mw = _port("pagerank", oocore=dict(num_super_shards=3, hot_fraction=0.0,
                                       prefetch=False))
    res = mw.run(max_iterations=3)
    assert mw.oocore_stats["overlap_efficiency"] == 0.0
    assert mw.oocore_stats["hidden_s"] == 0.0
    for r in res.per_iteration:
        assert r["oocore"]["wait_s"] == r["oocore"]["transfer_s"] > 0.0
        assert r["oocore"]["overlap_efficiency"] == 0.0
    assert mw.oocore_stats["max_live_groups"] == 1


# --------------------------------------------------------------------------
# guard rails
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs, match", [
    ({"daemon": "vectorized", "upper": "mesh"}, "fused"),
    ({"daemon": "sharded", "upper": "host"}, "fused"),
    ({"daemon": "sharded", "upper": "mesh", "model": "async"}, "BSP/GAS")])
def test_oocore_refuses_unfused_compositions(kwargs, match):
    """A composition that cannot stream raises as JAX's does, and never
    runs resident."""
    gj, gt = _graph()
    prog = "sssp_bf" if kwargs.get("model") else "pagerank"
    with pytest.raises(ValueError, match=match) as got:
        tplug.Middleware(gt, talg.ALGORITHMS[prog](gt), num_shards=SHARDS,
                         oocore=tplug.OocoreConfig(num_super_shards=2),
                         device="cpu", **kwargs)
    with pytest.raises(ValueError, match=match) as want:
        jplug.Middleware(gj, jalg.ALGORITHMS[prog](gj), num_shards=SHARDS,
                         oocore=jplug.OocoreConfig(num_super_shards=2),
                         **kwargs)
    assert str(got.value) == str(want.value)


def test_oocore_refuses_a_daemon_that_cannot_bind_super_shards():
    class NoStream(tplug.ShardedDaemon):
        bind_super_shards = None

    _, gt = _graph()
    assert not isinstance(NoStream(), tplug.OutOfCoreCapable)
    assert isinstance(tplug.ShardedDaemon(), tplug.OutOfCoreCapable)
    with pytest.raises(ValueError, match="OutOfCoreCapable"):
        tplug.Middleware(gt, talg.sssp_bf(gt), daemon=NoStream(),
                         upper="mesh", num_shards=SHARDS, device="cpu",
                         oocore=tplug.OocoreConfig(num_super_shards=2))


# --------------------------------------------------------------------------
# the port alone: the uploader, the groups, the fetch, the re-plan
# --------------------------------------------------------------------------
def test_uploader_keeps_two_groups_live_and_times_on_the_cpu():
    uploads = []

    def upload(i):
        uploads.append(i)
        return {"x": torch.full((3,), float(i))}

    up = toocore.AsyncUploader(upload, "cpu")
    up.request(0)  # the CPU has no side stream: take copies
    tree, transfer, wait = up.take(0)
    assert tree["x"][0].item() == 0.0 and uploads == [0]
    assert transfer is wait and transfer.seconds() >= 0.0
    up.request(1)
    up.release(0)
    up.take(1)
    up.release(1)
    assert up.max_live_groups == 1
    up.close()


def test_run_all_shards_on_a_group_with_only_its_fields():
    """A cold group carries only ``{"csr": ...}`` (``kernel="cuda"``) or
    only the block fields (``kernel="reference"``), nothing of the resident
    stack, and ``run_all_shards`` runs on it."""
    for kernel, keys in (("cuda", {"csr"}),
                         ("reference", {"vids", "lsrc", "ldst", "weights",
                                        "emask", "gsrc"})):
        mw = _port(oocore=dict(num_super_shards=2, hot_fraction=0.0),
                   kernel=kernel, key="dense")
        d = mw.daemon
        assert d.stacked is None and d.hot_stacked is None
        group = d.upload_super_shard(0)
        assert set(group) == keys
        state, aux = (torch.from_numpy(a) for a in mw.program.init(mw.graph))
        p, c, br = d.run_all_shards(state, aux, None, stacked=group)
        assert p.shape == (d.m, mw.n, mw.k) and br.shape == (SHARDS,)
        assert int(br.sum()) > 0


def test_one_small_fetch_an_iteration(monkeypatch):
    """The group verdicts and every counter ride the iteration's one fetch;
    nothing vertex-sized comes back but the final state."""
    mw = _port(oocore=dict(num_super_shards=6, hot_fraction=0.0),
               key="road")
    calls = []
    for name in ("cpu", "tolist", "item", "__bool__", "__int__"):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, _n=name, _o=orig, **kw):
            calls.append((_n, self.numel()))
            return _o(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapper)
    res = mw.run(max_iterations=10)
    n = mw.n
    assert [c for c in calls if c[1] >= n] == [("cpu", n * mw.k)]
    assert [c[0] for c in calls if c[1] < n] == ["tolist"] * res.iterations
    assert mw.oocore_stats["skipped"] > 0


def test_oocore_replan_publishes_with_plan_output():
    """The re-plan under a smaller budget is one ``"oocore_replan"`` epoch
    whose plan is the rebuild's output, as tests/test_epoch.py holds JAX's;
    the next run is still exact."""
    oc = dict(hbm_budget=40_000, hot_fraction=0.3)
    mw, jmw = _port(oocore=oc), _jax(oocore=oc)
    assert mw.epochs.epoch.oocore_plan is mw.daemon.oocore_plan
    first = mw.run(max_iterations=MAX_IT)
    new = dict(hbm_budget=20_000, hot_fraction=0.2)
    ep = mw.oocore_replan(tplug.OocoreConfig(**new))
    jep = jmw.oocore_replan(jplug.OocoreConfig(**new))
    assert (ep.cause, ep.version) == (jep.cause, jep.version) == \
        ("oocore_replan", 1)
    assert ep.oocore_plan is mw.daemon.oocore_plan
    for key in ("super_shards_before", "hot_cols_before",
                "super_shards_after", "hot_cols_after"):
        assert ep.meta[key] == jep.meta[key], key
    assert ep.meta["hot_cols_after"] <= ep.meta["hot_cols_before"]
    assert ep.dirty_vertices is None and ep.meta["seconds"] >= 0.0
    res = mw.run(max_iterations=MAX_IT)
    np.testing.assert_array_equal(res.state, first.state)
    with pytest.raises(ValueError, match="out-of-core"):
        _port().oocore_replan()
