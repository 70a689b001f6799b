"""Elastic fault tolerance of the port (``dist/fault.py``,
``Middleware.migrate`` / ``rebalance``, ``MeshUpperSystem.remesh`` /
``migrate``, ``ShardedDaemon.remesh``, the fused loops' migration carries)
against the JAX package's, on the CPU.

The JAX side is its fused loop over 8 shards at whatever m its process's
CPU devices give it (``XLA_FLAGS`` asks for 8 when this module is the first
to start JAX); the port gets ``mesh=m`` on the daemon and the upper, with m
read from the JAX daemon, so its logical devices are JAX's devices and a
kill of device d names the same slot on both sides.  The port's
``kernel="cuda"`` runs the CSR tile's plain twin at ``CSRConfig()`` against
JAX ``kernel="pallas"`` at the counterpart config; ``kernel="reference"``
is the block body on both sides.  Every port test pins ``CSRConfig()``,
and a fixture clears ``autotune.CACHE`` and checks that nothing swept.

* the kill matrix {pagerank, sssp_bf, wcc} × {bsp, async} × both kernels:
  device 2 killed before iteration 3, 8 → 4 devices; migration records
  equal to JAX's (``killed``, ``device_ids``, ``assignment``,
  ``repartitioned``, ``dirty_vertices``, …); min programs in as many
  iterations and bit for bit, pagerank within rtol 1e-5 / atol 1e-6;
* cascading kills, a kill and a join back to 8, a kill of a device outside
  the axis, straggler reports (a Lemma-2 re-partition, and a second one by
  capacity drift), rebalance after a migration — each against JAX;
* ``FleetMonitor``, ``FailureSchedule``, ``reassign_shards``,
  ``detect_stragglers`` and ``elastic_plan`` on seeded inputs against
  JAX's;
* on the port alone: every layer re-targeted, re-ordered tilesets reused
  with no sweep, no vertex-sized tensor brought to the host by a BSP
  migration, the wiring refused on compositions without a fused loop, bad
  survivor axes refused before anything changes.
"""
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import plug as jplug  # noqa: E402
from repro.dist import fault as jfault  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.dist import fault as tfault  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from test_torch_fused import _graph, _jax_daemon  # noqa: E402

BLOCK = 256
SHARDS = 8
KILL_IT = 3
CAP = 300
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ["pagerank", "sssp_bf", "wcc"]
KERNELS = ["reference", "cuda"]
MIGRATION_KEYS = ("killed", "stragglers", "joined", "devices_before",
                  "devices_after", "device_ids", "assignment",
                  "repartitioned", "dirty_vertices")

_jax_runs: dict = {}


@pytest.fixture(autouse=True)
def _pinned_config():
    """Every middleware here pins ``CSRConfig()``: nothing may sweep."""
    autotune.CACHE.clear()
    yield
    assert autotune.CACHE.sweeps == 0
    autotune.CACHE.clear()


def _sched(pkg, kills=(), slow=(), recoveries=()):
    return pkg.FailureSchedule(kills=kills, slow=slow, recoveries=recoveries)


def _jax_mw(prog_name, model="bsp", kernel="reference", monitor=None,
            **sched):
    gj, _ = _graph(prog_name)
    return jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon(kernel),
        upper="mesh", model=model, num_shards=SHARDS, monitor=monitor,
        failures=_sched(jplug, **sched) if sched else None,
        options=jplug.PlugOptions(block_size=BLOCK))


def _jax_run(prog_name, model="bsp", kernel="reference", max_it=CAP,
             **sched):
    """(result, middleware) of the JAX fused loop under ``sched``, cached
    for the module."""
    key = (prog_name, model, kernel, max_it,
           tuple(sorted((k, tuple(v)) for k, v in sched.items())))
    if key not in _jax_runs:
        mw = _jax_mw(prog_name, model, kernel, **sched)
        _jax_runs[key] = (mw.run(max_iterations=max_it), mw)
    return _jax_runs[key]


def _jax_m() -> int:
    """The JAX fused loop's m over 8 shards in this process."""
    return _jax_mw("sssp_bf").daemon.m


def _port(prog_name, model="bsp", kernel="reference", m=None, monitor=None,
          **sched):
    _, gt = _graph(prog_name)
    m = _jax_m() if m is None else m
    return tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt),
        daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), model=model,
        num_shards=SHARDS, monitor=monitor,
        failures=_sched(tplug, **sched) if sched else None,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")


def _migrations(res):
    return [r["migration"] for r in res.per_iteration if "migration" in r]


def _assert_same_migrations(got, want):
    a, b = _migrations(got), _migrations(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in MIGRATION_KEYS:
            assert x[key] == y[key], (key, x[key], y[key])
        assert x["seconds"] >= 0.0
    # each migration lands on the same iteration
    assert [r["iteration"] for r in got.per_iteration if "migration" in r] \
        == [r["iteration"] for r in want.per_iteration if "migration" in r]


def _assert_same_state(prog_name, got, want):
    if prog_name == "pagerank":
        np.testing.assert_allclose(got, np.asarray(want), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def _reference(prog_name, max_it=CAP):
    _, gt = _graph(prog_name)
    return tplug.run_reference(gt, talg.ALGORITHMS[prog_name](gt),
                               max_iterations=max_it, device="cpu")[0]


# --------------------------------------------------------------------------
# the kill matrix against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("model", ["bsp", "async"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_kill_matrix_matches_jax(prog_name, model, kernel):
    """Device 2 dies before iteration 3: 8 → 4 logical devices, the
    orphaned shards reassigned by Lemma 2; the migrated run's records,
    iterations and fixed point are JAX's."""
    want, jmw = _jax_run(prog_name, model, kernel, kills=[(KILL_IT, 2)])
    assert jmw._fused_kind == model
    mw = _port(prog_name, model, kernel, kills=[(KILL_IT, 2)])
    assert mw._fused_kind == model
    res = mw.run(max_iterations=CAP)
    assert res.converged == want.converged
    assert res.converged
    if prog_name != "pagerank":
        # a sum adds in another order: its last iteration may move by one
        assert res.iterations == want.iterations
    _assert_same_migrations(res, want)
    (mig,) = _migrations(res)
    assert mig["killed"] == [2] and 2 not in mig["device_ids"]
    assert mig["devices_after"] < mig["devices_before"]
    assert "migration" in res.per_iteration[KILL_IT - 1]
    assert mw.daemon.m == mw.upper.m == mig["devices_after"] == jmw.daemon.m
    _assert_same_state(prog_name, res.state, want.state)
    if prog_name != "pagerank":
        np.testing.assert_array_equal(res.state, _reference(prog_name))
    if kernel == "cuda":
        assert "csr" in mw.daemon.stacked  # still the CSR fused path


@pytest.mark.parametrize("model", ["bsp", "async"])
def test_kill_records_match_jax_iteration_by_iteration(model):
    """With the same kernel on both sides every per-iteration record of a
    migrated sssp_bf run is JAX's (blocks run per shard, the active count,
    and under the async model the run mask, refreshes, θ and the device
    count, which drops from 8 to 4 at the kill)."""
    want, _ = _jax_run("sssp_bf", model, "reference", kills=[(KILL_IT, 2)])
    res = _port("sssp_bf", model, "reference", kills=[(KILL_IT, 2)]).run(
        max_iterations=CAP)
    keys = ["blocks_total", "blocks_run", "shard_blocks_run", "active"]
    if model == "async":
        keys += ["run_mask", "refreshed", "gen_run", "gen_skipped", "theta",
                 "devices"]
    assert len(res.per_iteration) == len(want.per_iteration)
    for a, b in zip(res.per_iteration, want.per_iteration):
        for key in keys:
            assert a[key] == b[key], (a["iteration"], key, a[key], b[key])


def test_cascading_kills_match_jax():
    """Two kills: 8 → 4 on [0, 2, 3, 4], then device 3 of that axis dies
    and the run re-plans among the remaining survivors — still exact."""
    sched = dict(kills=[(2, 1), (4, 3)])
    want, jmw = _jax_run("sssp_bf", max_it=60, **sched)
    mw = _port("sssp_bf", **sched)
    res = mw.run(max_iterations=60)
    _assert_same_migrations(res, want)
    migs = _migrations(res)
    assert len(migs) == 2
    assert migs[0]["device_ids"] == [0, 2, 3, 4]
    assert 3 not in migs[1]["device_ids"]
    assert mw.monitor.alive_hosts == jmw.monitor.alive_hosts == 6
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    np.testing.assert_array_equal(res.state, _reference("sssp_bf", 60))


@pytest.mark.parametrize("model", ["bsp", "async"])
def test_kill_and_join_match_jax(model):
    """Device 1 dies before iteration 2 and recovers before iteration 5:
    8 → 4 → 8, the second a ``"join"`` epoch."""
    sched = dict(kills=[(2, 1)], recoveries=[(5, 1)])
    want, _ = _jax_run("sssp_bf", model, max_it=200, **sched)
    mw = _port("sssp_bf", model, **sched)
    res = mw.run(max_iterations=200)
    assert res.converged and res.iterations == want.iterations
    _assert_same_migrations(res, want)
    migs = _migrations(res)
    if len(migs) == 2:  # the run outlasted the recovery
        assert migs[1]["joined"] == [1]
        assert migs[1]["devices_after"] == len(mw.fleet_devices)
        assert mw.epochs.epoch.cause == "join" and mw.epochs.version == 2
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


def test_kill_of_a_device_outside_the_axis_is_a_no_op():
    """After the first kill the axis is [0, 2, 3, 4]; device 5 dying then
    triggers nothing, on both sides."""
    sched = dict(kills=[(2, 1), (4, 5)])
    want, _ = _jax_run("sssp_bf", max_it=60, **sched)
    mw = _port("sssp_bf", **sched)
    res = mw.run(max_iterations=60)
    _assert_same_migrations(res, want)
    assert len(_migrations(res)) == 1 and mw.monitor.failed[5]
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


def test_straggler_report_repartitions_like_jax():
    """Device 5 reports 8× the others' step time: a Lemma-2 re-partition on
    the unchanged axis, the straggler's slot the smallest — the same
    partitions as JAX's — and the run stays exact.  The same straggler
    does not trigger a second migration on the next run."""
    slow = [(2, d, 8.0 if d == 5 else 1.0) for d in range(SHARDS)]
    want, jmw = _jax_run("sssp_bf", max_it=40, slow=slow)
    mw = _port("sssp_bf", slow=slow)
    res = mw.run(max_iterations=40)
    _assert_same_migrations(res, want)
    (mig,) = _migrations(res)
    assert mig["stragglers"] == [5] and mig["repartitioned"]
    for p, q in zip(mw.partitions, jmw.partitions):
        np.testing.assert_array_equal(p.src, q.src)
        np.testing.assert_array_equal(p.dst, q.dst)
    sizes = np.array([p.num_edges for p in mw.partitions])
    assert sizes[5] == sizes.min()
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    assert not _migrations(mw.run(max_iterations=40))


def test_straggler_drift_triggers_a_second_migration_like_jax():
    """The straggler handled once keeps degrading (10× worse): the
    monitor's drift from the acknowledged placement fires a second
    re-partition, as in JAX."""
    slow = [(1, d, 5.0 if d == 5 else 1.0) for d in range(SHARDS)]
    slow += [(3, 5, 50.0)]
    want, _ = _jax_run("sssp_bf", max_it=40, slow=slow)
    mw = _port("sssp_bf", slow=slow)
    res = mw.run(max_iterations=40)
    _assert_same_migrations(res, want)
    migs = _migrations(res)
    assert [m["stragglers"] for m in migs] == [[5], [5]]
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


def test_rebalance_after_migration_uses_survivor_capacities_like_jax():
    """The dead device's 100 s reports are dropped at the kill; rebalance()
    then takes the survivors' uniform step times: uniform fractions, as in
    JAX, and the capacity estimator restarted at the migration."""
    slow = [(2, d, 100.0 if d == 2 else 1.0) for d in range(SHARDS)]
    sched = dict(kills=[(2, 2)], slow=slow)
    _, jmw = _jax_run("sssp_bf", max_it=40, **sched)
    mw = _port("sssp_bf", **sched)
    res = mw.run(max_iterations=40)
    assert len(_migrations(res)) == 1
    assert not mw._estimator.observed
    assert mw._estimator.epoch == mw.epochs.version == 1
    fr = mw.rebalance()
    np.testing.assert_allclose(fr, jmw.rebalance())
    np.testing.assert_allclose(fr, np.full(SHARDS, 1.0 / SHARDS))
    assert mw.epochs.epoch.cause == "rebalance"
    np.testing.assert_array_equal(mw.run(max_iterations=40).state,
                                  _reference("sssp_bf", 40))


def test_rebalance_without_any_observation_still_raises():
    mw = _port("sssp_bf", monitor=tplug.FleetMonitor(num_hosts=_jax_m()))
    with pytest.raises(ValueError, match="busy times"):
        mw.rebalance()


# --------------------------------------------------------------------------
# the port alone: layers, tiles, transfers, wiring
# --------------------------------------------------------------------------
def test_migration_retargets_every_layer():
    """After the kill, daemon and upper share the survivor axis, the dead
    device is gone from it, every shard is assigned once and never past
    the cap, and a second run on the migrated middleware is exact."""
    mw = _port("sssp_bf", kills=[(KILL_IT, 2)])
    res = mw.run(max_iterations=40)
    (mig,) = _migrations(res)
    m = mig["devices_after"]
    assert mw.daemon.m == mw.upper.m == mw.daemon.mesh == mw.upper.mesh == m
    assert mw.epochs.epoch.mesh == m and mw.epochs.epoch.cause == "kill"
    assert mw.monitor.failed[2] and 2 not in mw._mesh_device_ids
    counts = np.bincount(mig["assignment"], minlength=m)
    assert counts.sum() == SHARDS and counts.max() <= SHARDS // m
    ref = _reference("sssp_bf", 40)
    np.testing.assert_array_equal(res.state, ref)
    np.testing.assert_array_equal(mw.run(max_iterations=40).state, ref)


def test_external_mark_failed_migrates_without_a_schedule():
    m = _jax_m()
    mon = tplug.FleetMonitor(num_hosts=m, model_parallel=1)
    mw = _port("sssp_bf", monitor=mon)
    mon.mark_failed(0)
    res = mw.run(max_iterations=40)
    (mig,) = _migrations(res)
    assert mig["killed"] == [] and 0 not in mig["device_ids"]
    np.testing.assert_array_equal(res.state, _reference("sssp_bf", 40))


@pytest.mark.parametrize("model", ["bsp", "async"])
def test_migration_reuses_tiles_and_config(model):
    """A kill re-orders the shards without re-partitioning: bind_shards
    finds every BlockSet in its tile cache (``tilesets_reused`` += 8, no
    tile recut) and keeps the binding's CSR config (no sweep)."""
    mw = _port("sssp_bf", model, "cuda", kills=[(KILL_IT, 2)])
    d = mw.daemon
    recut, reused = d.tiles_recut, d.tilesets_reused
    cfg = d._csr_config
    mw.run(max_iterations=CAP)
    assert d.tiles_recut == recut
    assert d.tilesets_reused == reused + SHARDS
    assert d._csr_config is cfg


def test_async_migration_rearms_the_buckets():
    """bind_shards re-stacks without the priority buckets' adjacency; the
    async loop re-arms them at the migration (the buckets arm)
    and the fixed point stays exact."""
    model = tplug.AsyncModel(theta0=10.0, decay=0.9, bucket_k=8)
    jmodel = jplug.AsyncModel(theta0=10.0, decay=0.9, bucket_k=8)
    gj, _ = _graph("sssp_bf")
    jmw = jplug.Middleware(
        gj, jalg.sssp_bf(gj), daemon=_jax_daemon("cuda"), upper="mesh",
        model=jmodel, num_shards=SHARDS,
        failures=jplug.FailureSchedule(kills=[(KILL_IT, 2)]),
        options=jplug.PlugOptions(block_size=BLOCK))
    want = jmw.run(max_iterations=CAP)
    mw = _port("sssp_bf", model, "cuda", kills=[(KILL_IT, 2)])
    res = mw.run(max_iterations=CAP)
    assert "bucket" in mw.daemon.stacked
    assert mw.daemon.stacked["bucket"]["ptr"].shape[0] == SHARDS
    _assert_same_migrations(res, want)
    assert res.iterations == want.iterations
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


_TRANSFERS = ("cpu", "tolist", "item", "__bool__", "__int__", "__float__",
              "__index__")


def test_bsp_migration_brings_nothing_to_the_host(monkeypatch):
    """A BSP kill keeps the iteration's one small fetch and adds none: no
    vertex-sized tensor reaches the host during the migration, and the
    final state crosses once."""
    mw = _port("pagerank", kernel="cuda", kills=[(KILL_IT, 2)])
    n = mw.n
    calls = []

    def counting(name, orig):
        def wrapper(self, *args, **kwargs):
            calls.append((name, self.numel()))
            return orig(self, *args, **kwargs)
        return wrapper

    for name in _TRANSFERS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    res = mw.run(max_iterations=8)
    assert len(_migrations(res)) == 1 and res.iterations == 8
    assert [c for c in calls if c[1] >= n] == [("cpu", n * mw.k)]
    assert [c[0] for c in calls if c[1] < n] == ["tolist"] * 8


def test_elastic_wiring_requires_a_fused_composition():
    _, gt = _graph("sssp_bf")
    prog = talg.sssp_bf(gt)
    sched = tplug.FailureSchedule(kills=[(1, 0)])
    opts = tplug.PlugOptions(block_size=BLOCK)
    with pytest.raises(ValueError, match="fused"):
        tplug.Middleware(gt, prog, daemon="reference", upper="host",
                         num_shards=2, failures=sched, options=opts,
                         device="cpu")
    with pytest.raises(ValueError, match="fused"):
        tplug.Middleware(gt, prog, daemon="sharded", upper="host",
                         num_shards=2, failures=sched, options=opts,
                         device="cpu")
    with pytest.raises(ValueError, match="monitor tracks"):
        _port("sssp_bf", monitor=tplug.FleetMonitor(num_hosts=3))
    with pytest.raises(ValueError, match="monitor="):
        _port("sssp_bf").migrate()


def test_remesh_rejects_a_bad_survivor_axis_before_changing_anything():
    _, gt = _graph("sssp_bf")
    upper = tplug.MeshUpperSystem(mesh=8).bind(talg.sssp_bf(gt), SHARDS)
    with pytest.raises(ValueError, match="divide"):
        upper.remesh(3)
    with pytest.raises(NotImplementedError, match="item 13"):
        upper.remesh(("shard", 4))
    assert upper.m == upper.mesh == 8  # nothing changed
    assert upper.remesh(2) is upper and upper.m == upper.mesh == 2
    tree = (torch.zeros(3), torch.ones(2))
    assert upper.migrate(tree) is tree  # already on the card: no copy
    assert isinstance(upper, tplug.ElasticUpper)
    assert not isinstance(tplug.HostUpperSystem(), tplug.ElasticUpper)
    with pytest.raises(RuntimeError, match="bind_shards"):
        tplug.ShardedDaemon().remesh(2)


def test_oocore_replan_waits_for_item_11():
    """Item 11 is ported: ``oocore_replan`` plans as JAX's does at every
    axis length, budget and explicit split, and refuses a non-divisor
    axis."""
    from repro.oocore import OocoreConfig as JConfig
    from repro_torch.oocore import OocoreConfig as TConfig

    for cfg in (dict(hbm_budget=4096, hot_fraction=0.25),
                dict(hbm_budget=100, hot_fraction=0.0),
                dict(num_super_shards=3, hot_fraction=0.3)):
        for mesh in (8, 4, 2, 1):
            got = tfault.oocore_replan(64, 16, 8, mesh, TConfig(**cfg))
            want = jfault.oocore_replan(64, 16, 8, mesh, JConfig(**cfg))
            assert vars(got) == vars(want), (cfg, mesh)
    with pytest.raises(ValueError, match="divisible"):
        tfault.oocore_replan(10, 100, 8, 3, TConfig(num_super_shards=2))


# --------------------------------------------------------------------------
# dist/fault.py's parts on seeded inputs against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fleet_monitor_matches_jax(seed):
    """The same report / failure / recovery / epoch sequence through both
    monitors gives the same views at every step."""
    rng = np.random.default_rng(seed)
    hosts = 6
    a = tfault.FleetMonitor(num_hosts=hosts, window=4, straggler_factor=1.5,
                            drift_threshold=0.5)
    b = jfault.FleetMonitor(num_hosts=hosts, window=4, straggler_factor=1.5,
                            drift_threshold=0.5)

    def same():
        np.testing.assert_array_equal(a.mean_times(), b.mean_times())
        np.testing.assert_array_equal(a.stragglers(), b.stragglers())
        np.testing.assert_allclose(a.batch_fractions(), b.batch_fractions(),
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(a.failed, b.failed)
        assert a.capacity_drift() == b.capacity_drift()
        assert a.drifted() == b.drifted()
        assert (a.observed, a.alive_hosts, a.epoch) == \
            (b.observed, b.alive_hosts, b.epoch)

    same()
    for step in range(24):
        op = rng.integers(0, 10)
        h = int(rng.integers(0, hosts))
        if op < 6:
            s = float(rng.lognormal(0.0, 1.0))
            a.record(h, s)
            b.record(h, s)
        elif op == 6 and a.alive_hosts > 1:
            a.mark_failed(h)
            b.mark_failed(h)
        elif op == 7:
            a.mark_recovered(h)
            b.mark_recovered(h)
        elif op == 8:
            np.testing.assert_array_equal(a.ack_capacity(), b.ack_capacity())
        else:
            a.on_epoch(step)
            b.on_epoch(step)
        same()
    np.testing.assert_array_equal(a.reassign(12, cap=4),
                                  b.reassign(12, cap=4))


@pytest.mark.parametrize("seed", range(4))
def test_reassign_and_stragglers_match_jax(seed):
    rng = np.random.default_rng(seed)
    frac = rng.random(6)
    frac[rng.integers(0, 6)] = 0.0  # a dead host
    for shards, cap in ((6, None), (12, 3), (24, 6)):
        np.testing.assert_array_equal(
            tfault.reassign_shards(shards, frac, cap=cap),
            jfault.reassign_shards(shards, frac, cap=cap))
    times = rng.lognormal(0.0, 1.0, 9)
    times[rng.integers(0, 9)] = np.nan  # a host that never reported
    for factor in (1.2, 1.5, 3.0):
        np.testing.assert_array_equal(
            tfault.detect_stragglers(times, factor=factor),
            jfault.detect_stragglers(times, factor=factor))
    with pytest.raises(ValueError, match="cannot place"):
        tfault.reassign_shards(12, frac, cap=1)
    with pytest.raises(ValueError, match="live host"):
        tfault.reassign_shards(4, np.zeros(3))


@pytest.mark.parametrize("devices, mp", [(8, 1), (7, 1), (64, 4), (300, 16),
                                         (1024, 2)])
def test_elastic_plan_matches_jax(devices, mp):
    a = tfault.elastic_plan(devices, model_parallel=mp)
    b = jfault.elastic_plan(devices, model_parallel=mp)
    assert (a.shape, a.axis_names) == (b.shape, b.axis_names)
    assert (a.size, a.model_parallel, a.data_parallel) == \
        (b.size, b.model_parallel, b.data_parallel)
    with pytest.raises(ValueError):
        tfault.elastic_plan(3, model_parallel=4)


def test_failure_schedule_matches_jax():
    """Events fire at the first poll at or after their iteration, once
    each, in order; ``reset`` re-arms them."""
    kw = dict(kills=[(3, 2), (1, 0), (3, 1)], slow=[(2, 1, 4.0), (5, 0, 2)],
              recoveries=[(4, 0)])
    a, b = tfault.FailureSchedule(**kw), jfault.FailureSchedule(**kw)
    for it in (1, 1, 2, 4, 7):
        assert a.kills_at(it) == b.kills_at(it)
        assert a.slow_reports(it) == b.slow_reports(it)
        assert a.recoveries_at(it) == b.recoveries_at(it)
        assert a.exhausted == b.exhausted
    assert a.exhausted
    a.reset()
    assert not a.exhausted and a.kills_at(10) == [0, 1, 2]  # by iteration
