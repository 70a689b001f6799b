"""The port's structure-epoch layer (``plug/epoch.py`` and the middleware's
publishers, hooks and poll) against the JAX package's, on the CPU.

* the bus on its own: ordered named hooks, all-or-nothing version
  advance, the ``rebuilding`` flag, canonical dirty vertices — the cases of
  tests/test_epoch.py, on the port's bus, with the same ``CAUSES``;
* the four ported triggers through one ``publish``: a kill, a join, a
  rebalance and a mutation each leave the epoch JAX's does (cause, version,
  meta), and the out-of-core re-plan raises naming item 11;
* the refactor's invariant, statically and at run time: no port drive loop
  holds a rebuild call (``_REBUILD_CALLS`` of tests/test_epoch.py), and
  every ``remesh`` / ``bind_shards`` lands inside a publish;
* rebuild-path equivalence: whatever rebuilt the structure, sssp_bf's
  fixed point is bit-equal to a middleware built fresh on the post-trigger
  structure and to JAX's run of the same trigger;
* the capacity views keyed to the epoch, and the host path's hooks
  (``upper.bind``, ``prune_block_caches``).

The fused side runs at m read from the JAX daemon (8 when this module is
the first to start JAX), ``CSRConfig()`` pinned.
"""
import inspect
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import plug as jplug  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import mutation as jmutation  # noqa: E402
from repro.plug import epoch as jepoch  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.core.balance import CapacityEstimator  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph import mutation as tmutation  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from repro_torch.plug.epoch import (CAUSES, StructureEpoch,  # noqa: E402
                                    StructureEpochBus)
from test_epoch import _REBUILD_CALLS  # noqa: E402
from test_torch_fused import (_graph, _jax_daemon,  # noqa: E402
                             jax_config)

SHARDS = 8
BLOCK = 256
KILL = dict(kills=[(2, 2)])
JOIN = dict(kills=[(2, 1)], recoveries=[(5, 1)])
ADDS = ((7, 101, 1.0), (200, 3, 2.0))


@pytest.fixture(autouse=True)
def _pinned_config():
    autotune.CACHE.clear()
    yield
    assert autotune.CACHE.sweeps == 0


def _jax_mw(kernel="reference", **sched):
    gj, _ = _graph("sssp_bf")
    return jplug.Middleware(
        gj, jalg.sssp_bf(gj), daemon=_jax_daemon(kernel), upper="mesh",
        num_shards=SHARDS, options=jplug.PlugOptions(block_size=BLOCK),
        failures=jplug.FailureSchedule(**sched) if sched else None)


def _mw(kernel="reference", graph=None, m=None, **sched):
    gt = _graph("sssp_bf")[1] if graph is None else graph
    m = _jax_mw().daemon.m if m is None else m
    return tplug.Middleware(
        gt, talg.sssp_bf(gt),
        daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu",
        failures=tplug.FailureSchedule(**sched) if sched else None)


def _jax_vectorized(kernel):
    """JAX's host-path daemon counterpart of the port's ``kernel``."""
    if kernel == "reference":
        return "reference"
    return jplug.get_daemon("pallas", csr_config=jax_config(CSRConfig()))


def _epoch0():
    return StructureEpoch(version=0, cause="init", mesh=None,
                          partitions=(), blocksets=())


def _log(pkg):
    log = pkg.MutationLog()
    for u, v, w in ADDS:
        log.add_edge(u, v, w)
    return log


# --------------------------------------------------------------------------
# the bus
# --------------------------------------------------------------------------
def test_causes_match_jax():
    assert CAUSES == jepoch.CAUSES
    assert set(CAUSES) == {"init", "kill", "join", "rebalance",
                           "oocore_replan", "mutation"}


def test_bus_starts_uninitialized():
    bus = StructureEpochBus()
    assert bus.epoch is None and bus.version == -1 and not bus.rebuilding
    with pytest.raises(RuntimeError):
        bus.publish("kill", mesh=None, partitions=(), blocksets=())


def test_initialize_requires_init_cause_and_is_once():
    bus = StructureEpochBus()
    with pytest.raises(ValueError):
        bus.initialize(StructureEpoch(version=0, cause="kill", mesh=None,
                                      partitions=(), blocksets=()))
    bus.initialize(_epoch0())
    assert bus.version == 0
    with pytest.raises(RuntimeError):
        bus.initialize(_epoch0())


def test_publish_rejects_unknown_and_init_cause():
    bus = StructureEpochBus()
    bus.initialize(_epoch0())
    for cause in ("remesh", "restart", "init", ""):
        with pytest.raises(ValueError):
            bus.publish(cause, mesh=None, partitions=(), blocksets=())
    assert bus.version == 0


def test_hooks_run_in_subscription_order_with_old_epoch():
    bus = StructureEpochBus()
    bus.initialize(_epoch0())
    calls = []
    for name in ("a", "b"):
        bus.subscribe(name, lambda new, old, name=name: calls.append(
            (name, new.version, old.version)))
    ep = bus.publish("rebalance", mesh=None, partitions=(), blocksets=())
    assert calls == [("a", 1, 0), ("b", 1, 0)]
    assert ep is bus.epoch and ep.version == 1


def test_resubscribe_replaces_in_place_keeping_position():
    bus = StructureEpochBus()
    bus.initialize(_epoch0())
    calls = []
    bus.subscribe("a", lambda new, old: calls.append("a1"))
    bus.subscribe("b", lambda new, old: calls.append("b"))
    bus.subscribe("a", lambda new, old: calls.append("a2"))
    assert bus.subscribers == ["a", "b"]
    bus.publish("rebalance", mesh=None, partitions=(), blocksets=())
    assert calls == ["a2", "b"]
    bus.unsubscribe("a")
    assert bus.subscribers == ["b"]


def test_failed_hook_leaves_bus_on_old_version():
    bus = StructureEpochBus()
    bus.initialize(_epoch0())
    ran = []
    bus.subscribe("ok", lambda new, old: ran.append(new.version))

    def boom(new, old):
        raise RuntimeError("rebuild failed")

    bus.subscribe("boom", boom)
    with pytest.raises(RuntimeError, match="rebuild failed"):
        bus.publish("kill", mesh=None, partitions=(), blocksets=())
    assert bus.version == 0 and ran == [1] and not bus.rebuilding


def test_rebuilding_flag_spans_exactly_the_hook_dispatch():
    bus = StructureEpochBus()
    bus.initialize(_epoch0())
    seen = []
    bus.subscribe("spy", lambda new, old: seen.append(bus.rebuilding))
    bus.publish("mutation", mesh=None, partitions=(), blocksets=())
    assert seen == [True] and not bus.rebuilding


def test_publish_canonicalizes_dirty_vertices_like_jax():
    ours, theirs = StructureEpochBus(), jepoch.StructureEpochBus()
    for bus, e0 in ((ours, _epoch0()), (theirs, jepoch.StructureEpoch(
            version=0, cause="init", mesh=None, partitions=(),
            blocksets=()))):
        bus.initialize(e0)
    a = ours.publish("mutation", mesh=None, partitions=(), blocksets=(),
                     dirty_vertices=[5, 1, 5, 3])
    b = theirs.publish("mutation", mesh=None, partitions=(), blocksets=(),
                       dirty_vertices=[5, 1, 5, 3])
    np.testing.assert_array_equal(a.dirty_vertices, b.dirty_vertices)
    assert a.dirty_vertices.dtype == np.int64 and not a.global_change
    assert ours.publish("rebalance", mesh=None, partitions=(),
                        blocksets=()).global_change


# --------------------------------------------------------------------------
# the ported triggers through the middleware's bus
# --------------------------------------------------------------------------
def test_middleware_initializes_epoch_zero():
    mw = _mw()
    ep = mw.epochs.epoch
    assert mw.epochs.version == 0 and ep.cause == "init"
    assert mw.epochs.subscribers == ["upper", "daemon", "capacity"]
    assert ep.partitions == tuple(mw.partitions)
    assert ep.blocksets == tuple(mw.blocksets)
    assert ep.mesh == mw.upper.mesh == mw.daemon.m
    host = tplug.Middleware(mw.graph, mw.program, device="cpu")
    assert host.epochs.epoch.mesh is None


@pytest.mark.parametrize("trigger", ["kill", "join"])
def test_kill_and_join_publish_jax_epochs(trigger):
    sched = KILL if trigger == "kill" else JOIN
    jmw = _jax_mw(**sched)
    jmw.run(max_iterations=200)
    mw = _mw(**sched)
    assert mw.run(max_iterations=200).converged
    ep, jep = mw.epochs.epoch, jmw.epochs.epoch
    assert (mw.epochs.version, ep.cause) == (jmw.epochs.version, jep.cause)
    assert ep.cause == trigger
    for key in ("killed", "joined", "stragglers", "devices_before",
                "devices_after", "device_ids", "assignment",
                "repartitioned", "dirty_vertices"):
        assert ep.meta[key] == jep.meta[key], key
    assert ep.mesh == ep.meta["devices_after"] == mw.daemon.m
    assert ep.global_change == jep.global_change


def test_rebalance_publishes_the_jax_epoch():
    caps = np.linspace(1.0, 2.0, SHARDS)
    jmw = _jax_mw()
    mw = _mw()
    np.testing.assert_array_equal(mw.rebalance(capacities=caps),
                                  jmw.rebalance(capacities=caps))
    ep = mw.epochs.epoch
    assert (mw.epochs.version, ep.cause) == (1, "rebalance")
    assert ep.global_change
    assert ep.meta["fractions"] == jmw.epochs.epoch.meta["fractions"]
    for p, q in zip(mw.partitions, jmw.partitions):
        np.testing.assert_array_equal(p.src, q.src)


def test_mutation_publishes_the_jax_epoch():
    mw, jmw = _mw(), _jax_mw()
    ep = mw.apply_mutations(_log(tmutation))
    jep = jmw.apply_mutations(_log(jmutation))
    assert (ep.cause, ep.version) == (jep.cause, jep.version) == \
        ("mutation", 1)
    np.testing.assert_array_equal(ep.dirty_vertices, jep.dirty_vertices)
    np.testing.assert_array_equal(ep.meta["frontier"], jep.meta["frontier"])
    for key in ("incremental", "edges_added", "edges_removed",
                "vertices_added", "vertices_removed", "dirty_count",
                "shards_recut", "shards_clean"):
        assert ep.meta[key] == jep.meta[key], key
    assert ep.meta["seconds"] >= 0.0


def test_empty_mutation_publishes_nothing():
    mw = _mw()
    assert mw.apply_mutations(tplug.MutationLog()) is mw.epochs.epoch
    assert mw.epochs.version == 0


def test_oocore_replan_waits_for_item_11():
    """Item 11 is ported: the re-plan publishes an ``"oocore_replan"``
    epoch whose plan is the rebuild's output, with JAX's meta, and needs an
    out-of-core composition (tests/test_epoch.py's two cases)."""
    _, gt = _graph("sssp_bf")
    gj, _ = _graph("sssp_bf")
    m = _jax_mw().daemon.m
    cfg = dict(hbm_budget=40_000, hot_fraction=0.3)
    mw = tplug.Middleware(
        gt, talg.sssp_bf(gt),
        daemon=tplug.ShardedDaemon(mesh=m, csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu",
        oocore=tplug.OocoreConfig(**cfg))
    jmw = jplug.Middleware(
        gj, jalg.sssp_bf(gj), daemon="sharded", upper="mesh",
        num_shards=SHARDS, options=jplug.PlugOptions(block_size=BLOCK),
        oocore=jplug.OocoreConfig(**cfg))
    assert mw.epochs.epoch.oocore_plan is mw.daemon.oocore_plan
    new = dict(hbm_budget=20_000, hot_fraction=0.2)
    ep = mw.oocore_replan(tplug.OocoreConfig(**new))
    jep = jmw.oocore_replan(jplug.OocoreConfig(**new))
    assert (ep.cause, ep.version) == (jep.cause, jep.version) == \
        ("oocore_replan", 1)
    assert ep.oocore_plan is mw.daemon.oocore_plan
    assert ep.global_change and ep.dirty_vertices is None
    for key in ("super_shards_before", "hot_cols_before",
                "super_shards_after", "hot_cols_after"):
        assert ep.meta[key] == jep.meta[key], key
    assert ep.meta["hot_cols_after"] <= ep.meta["hot_cols_before"]
    with pytest.raises(ValueError, match="out-of-core"):
        _mw().oocore_replan()


# --------------------------------------------------------------------------
# enforcement: loops react to the version, they never rebuild
# --------------------------------------------------------------------------
@pytest.mark.parametrize("loop_cls", [tplug.DriveLoop, tplug.AsyncDriveLoop,
                                      tplug.HostDriveLoop,
                                      tplug.OocoreDriveLoop])
def test_drive_loops_never_call_rebuild_methods(loop_cls):
    """No port drive loop's source holds a structure-rebuild call: they go
    through ``Middleware._poll_structure`` → publish → hooks, and adopt the
    result by the bus version."""
    mro = [c for c in inspect.getmro(loop_cls) if c is not object]
    src = "".join(inspect.getsource(c) for c in set(mro))
    for token in _REBUILD_CALLS:
        assert token not in src, (loop_cls.__name__, token)


@pytest.mark.parametrize("model", ["bsp", "async"])
def test_rebuilds_happen_only_while_the_bus_is_rebuilding(model):
    """Every ``remesh`` of the upper and the daemon, and every
    ``bind_shards``, lands inside a publish — for a mid-run kill, a
    between-runs rebalance and a mid-run mutation."""
    _, gt = _graph("sssp_bf")
    m = _jax_mw().daemon.m
    log = _log(tmutation)
    mw = tplug.Middleware(
        gt, talg.sssp_bf(gt), model=model,
        daemon=tplug.ShardedDaemon(kernel="cuda", mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu",
        failures=tplug.FailureSchedule(**KILL),
        mutations=tplug.MutationSchedule(events=[(4, log)]))
    states = []

    def spy(obj, name):
        orig = getattr(obj, name)

        def wrapped(*a, **kw):
            states.append((name, mw.epochs.rebuilding))
            return orig(*a, **kw)

        setattr(obj, name, wrapped)

    for obj, name in ((mw.upper, "remesh"), (mw.daemon, "remesh"),
                      (mw.daemon, "bind_shards")):
        spy(obj, name)
    res = mw.run()
    assert res.converged
    assert [r["iteration"] for r in res.per_iteration
            if "migration" in r or "mutation" in r] == [2, 4]
    mw.rebalance(capacities=np.linspace(1.0, 2.0, SHARDS))
    assert mw.epochs.version == 3
    assert len(states) == 9  # three of each, one set per trigger
    assert all(inside for _, inside in states)


# --------------------------------------------------------------------------
# rebuild-path equivalence
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("trigger", ["kill", "join", "rebalance",
                                     "mutation", "oocore_replan"])
def test_rebuild_path_equivalence(trigger, kernel):
    """Whatever rebuilt the structure, the fixed point is bit-equal to a
    middleware built fresh on the post-trigger graph, and to JAX's run of
    the same trigger."""
    _, gt = _graph("sssp_bf")
    g_final = gt
    jkernel = "reference" if kernel == "reference" else "cuda"
    if trigger in ("kill", "join"):
        sched = KILL if trigger == "kill" else JOIN
        mw, jmw = _mw(kernel, **sched), _jax_mw(jkernel, **sched)
        res, want = mw.run(max_iterations=200), jmw.run(max_iterations=200)
    elif trigger == "rebalance":
        mw, jmw = _mw(kernel), _jax_mw(jkernel)
        caps = np.linspace(2.0, 1.0, SHARDS)
        mw.rebalance(capacities=caps)
        jmw.rebalance(capacities=caps)
        res, want = mw.run(), jmw.run()
    elif trigger == "oocore_replan":
        gj, _ = _graph("sssp_bf")
        m = _jax_mw().daemon.m
        cfg, new = (dict(hbm_budget=40_000, hot_fraction=0.3),
                    dict(hbm_budget=20_000, hot_fraction=0.2))
        mw = tplug.Middleware(
            gt, talg.sssp_bf(gt),
            daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                       csr_config=CSRConfig()),
            upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
            options=tplug.PlugOptions(block_size=BLOCK), device="cpu",
            oocore=tplug.OocoreConfig(**cfg))
        jmw = jplug.Middleware(
            gj, jalg.sssp_bf(gj), daemon=_jax_daemon(jkernel),
            upper="mesh", num_shards=SHARDS,
            options=jplug.PlugOptions(block_size=BLOCK),
            oocore=jplug.OocoreConfig(**cfg))
        mw.run()
        jmw.run()
        mw.oocore_replan(tplug.OocoreConfig(**new))
        jmw.oocore_replan(jplug.OocoreConfig(**new))
        res, want = mw.run(), jmw.run()
    else:
        mw, jmw = _mw(kernel), _jax_mw(jkernel)
        mw.run()
        jmw.run()
        mw.apply_mutations(_log(tmutation))
        jmw.apply_mutations(_log(jmutation))
        g_final, _ = tmutation.apply_to_graph(gt, _log(tmutation).freeze())
        res, want = mw.run(), jmw.run()
    assert res.converged and mw.epochs.version >= 1
    assert mw.epochs.version == jmw.epochs.version
    fresh = _mw(kernel, graph=g_final).run()
    np.testing.assert_array_equal(res.state, fresh.state)
    np.testing.assert_array_equal(res.state, np.asarray(want.state))


# --------------------------------------------------------------------------
# capacity views keyed to the epoch; the host path's hooks
# --------------------------------------------------------------------------
def test_estimator_is_rekeyed_per_epoch():
    mw = _mw()
    est0 = mw._estimator
    assert est0.epoch == 0
    mw.rebalance(capacities=np.linspace(1.0, 2.0, SHARDS))
    assert mw._estimator is not est0
    assert mw._estimator.epoch == mw.epochs.version == 1
    assert not mw._estimator.observed
    assert CapacityEstimator(4, epoch=7).epoch == 7


def test_monitor_on_epoch_collapses_windows_keeps_relative_capacity():
    mon = tplug.FleetMonitor(num_hosts=4, window=8)
    for _ in range(5):
        for h, s in enumerate([1.0, 1.0, 1.0, 4.0]):
            mon.record(h, s)
    mon.ack_capacity()
    before = mon.mean_times()
    mon.on_epoch(1)
    assert mon.epoch == 1 and all(len(d) == 1 for d in mon._times)
    np.testing.assert_allclose(mon.mean_times(), before)
    assert mon.capacity_drift() == pytest.approx(0.0, abs=1e-12)
    mon.record(3, 40.0)
    assert mon.drifted()
    mon.on_epoch(1)  # same version: nothing changes
    assert len(mon._times[3]) == 2


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_host_path_hooks_rebind_and_prune(kernel):
    """On the host loop a rebalance and a mutation re-bind the upper and
    prune the daemon's per-blockset tile cache to the bound blocksets; the
    host runs after them are exact, and JAX's host path agrees."""
    gj, gt = _graph("sssp_bf")
    mw = tplug.Middleware(gt, talg.sssp_bf(gt),
                          daemon=tplug.VectorizedDaemon(
                              kernel=kernel, csr_config=CSRConfig()),
                          num_shards=4, device="cpu",
                          options=tplug.PlugOptions(block_size=BLOCK))
    jmw = jplug.Middleware(gj, jalg.sssp_bf(gj), num_shards=4,
                           daemon=_jax_vectorized(kernel),
                           options=jplug.PlugOptions(block_size=BLOCK))
    assert mw.epochs.epoch.mesh is None and mw._fused_kind is None
    mw.run()
    before = set(mw.daemon._csr_cache)
    caps = np.array([1.0, 2.0, 1.0, 3.0])
    np.testing.assert_array_equal(mw.rebalance(capacities=caps),
                                  jmw.rebalance(capacities=caps))
    assert mw.epochs.epoch.cause == "rebalance"
    assert not (set(mw.daemon._csr_cache) & before)  # all pruned
    res = mw.run()
    np.testing.assert_array_equal(res.state, np.asarray(jmw.run().state))
    kept = set(mw.daemon._csr_cache)
    src0 = int(mw.partitions[1].src[0])
    ep = mw.apply_mutations(tplug.MutationLog().add_edge(src0, 9, 0.5))
    assert ep.meta["shards_recut"] == 1
    assert len(set(mw.daemon._csr_cache) & kept) == (
        3 if kernel == "cuda" else 0)
    jmw.apply_mutations(jplug.MutationLog().add_edge(src0, 9, 0.5))
    np.testing.assert_array_equal(mw.run().state,
                                  np.asarray(jmw.run().state))
