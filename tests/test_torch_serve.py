"""The port's serving layer (``repro_torch.serve``: the batched multi-source
programs, the per-query freeze of ``plug.middleware.apply_step``, the
admission queue, the result cache, the session, the router, workloads and
the launcher) against the JAX package's ``repro.serve``, on the CPU.

Graph and layout are ``tests/test_serve.py``'s: a 256-vertex R-MAT (seed
9), 8 shards, block 256.  The JAX side runs at whatever m its process's
CPU devices give it (``XLA_FLAGS`` asks for 8 when this module is the
first to start JAX); the port gets ``mesh=m``, read from a JAX daemon.
The port's ``kernel="reference"`` is held against JAX ``"reference"``,
and ``kernel="cuda"`` (the CSR tile's plain twin at ``CSRConfig()``)
against JAX ``"pallas"`` at the counterpart config (the Pallas tile in
interpret mode).  Every port session pins ``CSRConfig()``; a fixture
clears ``autotune.CACHE`` and checks that nothing swept.

* ``tests/test_serve.py``'s 15 contracts and ``tests/test_mutation.py``'s
  serving contracts, each port answer held against the JAX session's
  answer (min programs bit for bit; sums within rtol 1e-5 / atol 1e-6)
  as well as against ``run_reference``;
* parity: the batched programs' ``init`` arrays, ``apply_step``'s freeze
  against JAX's ``make_apply_fn`` on seeded (N, B) inputs and in all four
  drive loops (host, fused, async, out of core), ``generate_workload``,
  admission batch compositions under replay, ``batched_ppr``'s message
  function over every column, the exports;
* on the port alone: the freeze fetches nothing, ``kernel="cuda"`` refuses
  ``max_batch`` over the kernel's K ≤ 16, entry points refuse the card on
  a machine without one, and the launcher on the CPU.
"""
import os

# before JAX starts its backend: serving wants a multi-device host mesh
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import plug as jplug  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.dist import fault as jfault  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import generate as jgenerate  # noqa: E402
from repro.graph import mutation as jmutation  # noqa: E402
from repro.graph.structure import Graph as JGraph  # noqa: E402
from repro.plug.middleware import make_apply_fn as jmake_apply_fn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.dist import fault as tfault  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph import mutation as tmutation  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from repro_torch.launch import graph_serve  # noqa: E402
from repro_torch.plug.middleware import apply_step  # noqa: E402
from test_torch_fused import jax_config  # noqa: E402

SHARDS = 8
BLOCK = 256
REF_MAX_IT = 300
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
KERNELS = {"reference": "reference", "cuda": "pallas"}  # port → JAX
BATCHED = {"khop": (jalg.batched_khop, talg.batched_khop),
           "sssp": (jalg.batched_sssp, talg.batched_sssp),
           "ppr": (jalg.batched_ppr, talg.batched_ppr)}

_cache: dict = {}


@pytest.fixture(autouse=True)
def _pinned_config():
    """Every port session here pins ``CSRConfig()``: nothing may sweep."""
    autotune.CACHE.clear()
    yield
    assert autotune.CACHE.sweeps == 0
    autotune.CACHE.clear()


def _port_graph(gj):
    return convert.graph_from_arrays(gj.src, gj.dst, gj.weights,
                                     gj.num_vertices)


def _graphs():
    """(JAX graph, port graph): tests/test_serve.py's R-MAT."""
    if "g" not in _cache:
        gj = jgenerate.rmat(256, 2048, seed=9)
        _cache["g"] = (gj, _port_graph(gj))
    return _cache["g"]


def _jax_m() -> int:
    """The JAX fused loop's m over 8 shards in this process."""
    if "m" not in _cache:
        gj, _ = _graphs()
        _cache["m"] = jplug.Middleware(
            gj, jalg.sssp_bf(gj), daemon="sharded", upper="mesh",
            num_shards=SHARDS,
            options=jplug.PlugOptions(block_size=BLOCK)).daemon.m
    return _cache["m"]


class _JaxSession(jserve.GraphServeSession):
    """JAX's session with its ``"pallas"`` daemons at the counterpart of the
    port's ``CSRConfig()`` (JAX's session takes no ``csr_config``)."""

    def _make_daemon(self):
        if self.kernel != "pallas":
            return super()._make_daemon()
        d = jplug.get_daemon("sharded", kernel="pallas",
                             csr_config=jax_config(CSRConfig()))
        donor = self._donor_daemon()
        if donor is not None:
            d.share_from(donor)
        return d


def _jax_session(graph=None, kernel="reference", **kw):
    kw.setdefault("num_shards", SHARDS)
    kw.setdefault("block_size", BLOCK)
    return _JaxSession(graph if graph is not None else _graphs()[0],
                       kernel=KERNELS[kernel], **kw)


def _port_session(graph=None, kernel="reference", **kw):
    kw.setdefault("num_shards", SHARDS)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("mesh", _jax_m())
    return tserve.GraphServeSession(
        graph if graph is not None else _graphs()[1], kernel=kernel,
        csr_config=CSRConfig(), device="cpu", **kw)


def _shared(kernel):
    """One warm (port, JAX) session pair per kernel, reused by the
    read-only batched tests (every run re-inits from its own seeds)."""
    key = ("shared", kernel)
    if key not in _cache:
        _cache[key] = (_port_session(kernel=kernel),
                       _jax_session(kernel=kernel))
    return _cache[key]


def _execute(kernel, kind, params, seeds):
    """(port answers, port record, JAX answers, JAX record) of one batch."""
    port, jax = _shared(kernel)
    a, rec = port.execute_batch(kind, params, seeds)
    b, jrec = jax.execute_batch(kind, params, seeds)
    return a, rec, [np.asarray(x) for x in b], jrec


def _assert_same_answers(kind, got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if kind == "ppr" or kind == "lookup":
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL)
        else:
            np.testing.assert_array_equal(a, b)


def _reference_column(factory, seed_set, max_iterations=REF_MAX_IT,
                      graph=None):
    """The (N,) answer of a solo (B=1) run through the port's reference."""
    g = graph if graph is not None else _graphs()[1]
    state = tplug.run_reference(g, factory(g, [seed_set]),
                                max_iterations=max_iterations,
                                device="cpu")[0]
    return np.asarray(state)[:, 0]


# --------------------------------------------------------------------------
# batched ≡ single-source (the BatchQueryCapable contract)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("kind,params", [("sssp", ()),
                                         ("khop", (("hops", 2),))])
def test_batched_bit_identical_to_single_source(kind, params, kernel):
    """B mixed queries (a duplicate pair and a multi-seed set) in ONE fused
    run: each column bit-equal to its solo reference and to JAX's batched
    answer, the duplicates bit-equal, records as JAX's."""
    seeds = [3, 17, 17, (5, 9)]
    kw = dict(params)
    answers, rec, want, jrec = _execute(kernel, kind, params, seeds)
    assert rec["converged"] and rec["durable"]
    assert rec["iterations"] == jrec["iterations"]
    assert (rec["batch"], rec["bucket"]) == (jrec["batch"], jrec["bucket"])
    _assert_same_answers(kind, answers, want)
    factory = BATCHED[kind][1]
    for q, seed_set in enumerate(seeds):
        ref = _reference_column(lambda g, s: factory(g, s, **kw), seed_set)
        np.testing.assert_array_equal(answers[q], ref)
    np.testing.assert_array_equal(answers[1], answers[2])


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_batch_of_one_matches_reference(kernel):
    answers, rec, want, jrec = _execute(kernel, "sssp", (), [11])
    np.testing.assert_array_equal(answers[0],
                                  _reference_column(talg.batched_sssp, 11))
    _assert_same_answers("sssp", answers, want)
    assert rec["batch"] == 1 and rec["bucket"] == 1
    assert rec["iterations"] == jrec["iterations"]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_all_converged_early_exit(kernel):
    """A batch stops as soon as EVERY query's column is at its fixed point,
    in as many iterations as JAX's, and no batch-mate drags a finished
    column off its solo answer."""
    params = (("hops", 2),)
    _, solo, _, jsolo = _execute(kernel, "khop", params, [3])
    answers, rec, want, jrec = _execute(kernel, "khop", params,
                                        [3, 17, 17, 200])
    assert rec["converged"]
    assert rec["iterations"] < 20
    assert rec["iterations"] <= solo["iterations"] + 1
    assert (rec["iterations"], solo["iterations"]) == \
        (jrec["iterations"], jsolo["iterations"])
    _assert_same_answers("khop", answers, want)
    ref = _reference_column(lambda g, s: talg.batched_khop(g, s, hops=2), 3)
    np.testing.assert_array_equal(answers[0], ref)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_ppr_independent_of_batch_composition(kernel):
    """Sum-monoid PPR columns are independent (restart vectors live in
    separate columns), so the same query answers identically whichever
    batch it rides in — on the CPU bit for bit, as in JAX — and within
    rtol of JAX's answers."""
    a_solo, _, j_solo, _ = _execute(kernel, "ppr", (), [7])
    a_batch, rec, j_batch, jrec = _execute(kernel, "ppr", (), [7, (1, 2)])
    np.testing.assert_array_equal(a_solo[0], a_batch[0])
    assert not rec["durable"] and not jrec["durable"]
    assert rec["iterations"] == jrec["iterations"]
    _assert_same_answers("ppr", a_solo, j_solo)
    _assert_same_answers("ppr", a_batch, j_batch)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_families_share_stacked_block_tensors(kernel):
    """Per-family daemons adopt the first family's stacked device tensors
    (digest-verified) instead of placing their own: every field, as JAX's
    adopters adopt every one of theirs."""
    for kind, params, seeds in (("sssp", (), [1, 2]),
                                ("khop", (("hops", 2),), [4]),
                                ("ppr", (), [5])):
        _execute(kernel, kind, params, seeds)
    port, jax = _shared(kernel)
    fams = [f["mw"].daemon for f in port._families.values()]
    assert len(fams) >= 2
    first = next(d for d in fams if d.adopted_fields == 0)
    adopters = [d for d in fams if d is not first]
    n_fields = len(first._stacked_digests)
    assert all(d.adopted_fields == n_fields for d in adopters)
    assert all(d._stacked["vids"] is first._stacked["vids"]
               for d in adopters)
    if kernel == "cuda":
        assert all(d._stacked["csr"]["lsrc"] is first._stacked["csr"]["lsrc"]
                   for d in adopters)
    jfams = [f["mw"].daemon for f in jax._families.values()]
    jfirst = next(d for d in jfams if d.adopted_fields == 0)
    assert all(d.adopted_fields == len(jfirst._stacked_digests)
               for d in jfams if d is not jfirst)
    assert sorted(port.compiled_families) == sorted(jax.compiled_families)


# --------------------------------------------------------------------------
# admission queue: deterministic micro-batching, equal to JAX's
# --------------------------------------------------------------------------
def _keys(batches):
    return [[(p.query.kind, p.query.seeds, p.query.params, p.ticket,
              p.admitted) for p in batch] for batch in batches]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_queue_flushes_full_family_and_aged_family(pkg):
    serve = tserve if pkg == "port" else jserve
    clock = serve.VirtualClock()
    q = serve.AdmissionQueue(max_batch=2, max_wait=0.01, clock=clock)
    a = serve.Query.make("sssp", 1)
    b = serve.Query.make("sssp", 2)
    c = serve.Query.make("khop", 3, hops=2)
    q.submit(a)
    assert q.poll() == []
    q.submit(b)
    q.submit(c)
    due = q.poll()
    assert [[p.query for p in batch] for batch in due] == [[a, b]]
    assert len(q) == 1
    clock.advance(0.02)
    due = q.poll()
    assert [[p.query for p in batch] for batch in due] == [[c]]
    assert len(q) == 0


def test_queue_is_deterministic_under_replay():
    """Equal submissions + equal clock advances ⇒ equal batches, the wall
    clock never participates, and the port's batches are JAX's."""
    def drive(serve):
        clock = serve.VirtualClock()
        queue = serve.AdmissionQueue(max_batch=4, max_wait=0.005,
                                     clock=clock)
        out = []
        for i in range(7):
            queue.submit(serve.Query.make("sssp", i % 3))
            queue.submit(serve.Query.make("khop", i, hops=2))
            clock.advance(0.002)
            out.extend(_keys(queue.poll()))
        out.extend(_keys(queue.drain()))
        return out

    runs = [drive(tserve), drive(tserve)]
    assert runs[0] == runs[1]
    assert runs[0] == drive(jserve)


def test_clock_rejects_negative_advance():
    with pytest.raises(ValueError):
        tserve.VirtualClock().advance(-1.0)
    clock = tserve.VirtualClock(1.5)
    assert clock.advance(0.5) == 2.0 == jserve.VirtualClock(1.5).advance(0.5)


def test_query_canonicalization():
    """Seed order/duplicates never reach the cache key; params are part of
    the family split; keys equal JAX's."""
    Q = tserve.Query
    assert Q.make("sssp", (9, 3, 3)).cache_key == \
        Q.make("sssp", [3, 9]).cache_key
    assert Q.make("khop", 1, hops=2).family_key != \
        Q.make("khop", 1, hops=3).family_key
    with pytest.raises(ValueError):
        Q.make("sssp", [])
    for args, kw in (((("sssp", (9, 3, 3)),), {}), ((("khop", 1),),
                                                    {"hops": 2}),
                     ((("ppr", np.int64(4)),), {})):
        (kind, seeds), = args
        assert Q.make(kind, seeds, **kw).cache_key == \
            jserve.Query.make(kind, seeds, **kw).cache_key


class _FakeSession:
    """Records batch compositions; answers zeros.  No device."""

    def __init__(self, max_batch=4):
        self.max_batch = max_batch
        self.batches = []

    def execute_batch(self, kind, params, seeds_list):
        self.batches.append((kind, params, tuple(seeds_list)))
        return [np.zeros(4) for _ in seeds_list], {
            "kind": kind, "batch": len(seeds_list),
            "bucket": len(seeds_list), "iterations": 1, "converged": True,
            "service_s": 0.0, "durable": True, "migrations": [],
            "mesh_epoch": 0}


def _workload_keys(wl):
    return [(t, q.kind, q.seeds, q.params) for t, q in wl]


def _replayed(serve, wl, max_batch, max_wait):
    fake = _FakeSession(max_batch)
    router = serve.GraphServeRouter(fake, max_batch=max_batch,
                                    max_wait=max_wait)
    answers, stats = serve.replay(router, wl)
    return fake.batches, answers, stats


def test_replay_batches_are_deterministic():
    kw = dict(num_requests=60, num_vertices=100, rate=500.0, seed=5,
              repeat_fraction=0.3)
    wl = tserve.generate_workload(**kw)
    assert wl == tserve.generate_workload(**kw)
    compositions = []
    for _ in range(2):
        batches, _, stats = _replayed(tserve, wl, 4, 0.005)
        assert stats["completed"] == 60
        compositions.append(batches)
    assert compositions[0] == compositions[1]
    assert any(b[2] and len(b[2]) > 1 for b in compositions[0])
    jbatches, _, _ = _replayed(jserve, jserve.generate_workload(**kw), 4,
                               0.005)
    assert compositions[0] == jbatches


@pytest.mark.parametrize("kw", [
    dict(num_requests=60, num_vertices=100, rate=500.0, seed=5,
         repeat_fraction=0.3),
    dict(num_requests=200, num_vertices=1 << 20, rate=2000.0, seed=11,
         repeat_fraction=0.2, hops=3, max_seeds=3),
    dict(num_requests=40, num_vertices=256, rate=50.0, seed=0,
         kinds=("sssp", "ppr"), max_seeds=5),
])
def test_generate_workload_equals_jax(kw):
    got = tserve.generate_workload(**kw)
    want = jserve.generate_workload(**kw)
    assert _workload_keys(got) == _workload_keys(want)


@pytest.mark.parametrize("max_batch,max_wait", [(8, 0.005), (2, 0.0),
                                                (4, 0.05)])
def test_admission_batches_under_replay_equal_jax(max_batch, max_wait):
    """The batch compositions, queue waits and per-kind counts of a replay
    through the router are JAX's, for one seeded workload."""
    kw = dict(num_requests=120, num_vertices=1000, rate=800.0, seed=3,
              repeat_fraction=0.2)
    batches, answers, stats = _replayed(
        tserve, tserve.generate_workload(**kw), max_batch, max_wait)
    jbatches, janswers, jstats = _replayed(
        jserve, jserve.generate_workload(**kw), max_batch, max_wait)
    assert batches == jbatches
    assert [(a.query.cache_key, a.cached, a.queue_wait_s, a.batch)
            for a in answers] == \
        [(a.query.cache_key, a.cached, a.queue_wait_s, a.batch)
         for a in janswers]
    assert stats["completed"] == jstats["completed"] == 120
    assert {k: (v["count"], v["cached"], v["mean_batch"])
            for k, v in stats["kinds"].items()} == \
        {k: (v["count"], v["cached"], v["mean_batch"])
         for k, v in jstats["kinds"].items()}


# --------------------------------------------------------------------------
# result LRU
# --------------------------------------------------------------------------
def test_cache_hit_and_lru_eviction():
    stats = []
    for serve in (tserve, jserve):
        c = serve.ServeCache(capacity=2)
        c.insert(("a",), 1)
        c.insert(("b",), 2)
        assert c.lookup(("a",)) == 1
        c.insert(("c",), 3)
        assert ("b",) not in c and ("a",) in c and ("c",) in c
        assert c.stats.evicted == 1 and c.stats.hits == 1
        assert c.lookup(("b",)) is None
        assert c.stats.misses == 1
        stats.append(c.stats.as_dict())
    assert stats[0] == stats[1]
    with pytest.raises(ValueError):
        tserve.ServeCache(capacity=0)


def test_cache_invalidate_by_vertex_deps():
    c = tserve.ServeCache()
    c.insert(("a",), 1, deps=(3, 5))
    c.insert(("b",), 2, deps=(7,))
    c.insert(("c",), 3, deps=())
    c.insert(("d",), 4, deps=None)  # global support
    assert c.invalidate([5, 99]) == 2
    assert ("a",) not in c and ("d",) not in c
    assert ("b",) in c and ("c",) in c
    assert c.stats.invalidated == 2
    assert c.invalidate([]) == 0


def test_cache_flush_volatile_spares_durable():
    c = tserve.ServeCache()
    c.insert(("durable",), 1, durable=True)
    c.insert(("volatile",), 2, durable=False)
    assert c.flush_volatile() == 1
    assert ("durable",) in c and ("volatile",) not in c
    assert c.stats.flushed == 1


def test_scoped_flush_volatile_unit():
    for serve in (tserve, jserve):
        c = serve.ServeCache(16)
        c.insert("in", 1, deps=[3, 4], durable=False)
        c.insert("out", 2, deps=[9], durable=False)
        c.insert("depless", 3, deps=(), durable=False)
        c.insert("durable", 4, deps=[3], durable=True)
        assert c.flush_volatile(dirty={4}) == 2
        assert "out" in c and "durable" in c and "in" not in c
        assert c.flush_volatile(None) == 1


# --------------------------------------------------------------------------
# elastic shrink + grow under live traffic
# --------------------------------------------------------------------------
def _kill_scenario(serve, session):
    """tests/test_serve.py's acceptance scenario on one package's session:
    returns what it observed."""
    router = serve.GraphServeRouter(session, max_wait=0.0)
    t_warm, _ = router.submit(serve.Query.make("khop", 3, hops=2))
    router.clock.advance(0.01)
    assert router.pump() == 1
    warm = router.result(t_warm)
    assert warm is not None and not warm.cached
    router.cache.insert(("sentinel",), 0, durable=False)

    t_ppr, _ = router.submit(serve.Query.make("ppr", 7))
    router.clock.advance(0.01)
    assert router.pump() == 1
    out = {"epoch": session.mesh_epoch,
           "ppr_m": session._family("ppr", (), 1)["mw"].daemon.m,
           "sentinel": ("sentinel",) in router.cache,
           "flushed": router.cache.stats.flushed,
           "khop_kept": serve.Query.make("khop", 3, hops=2).cache_key
           in router.cache}
    t_hit, hit = router.submit(serve.Query.make("khop", 3, hops=2))
    assert hit is not None and hit.cached
    np.testing.assert_array_equal(hit.value, warm.value)
    answers, rec = session.execute_batch("sssp", (), [3, (5, 9)])
    out.update(warm=np.asarray(warm.value),
               ppr=np.asarray(router.result(t_ppr).value),
               sssp=[np.asarray(a) for a in answers],
               after_epoch=rec["mesh_epoch"], after_migs=rec["migrations"])
    return out


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_mid_serve_kill_migrates_flushes_volatile_and_keeps_serving(kernel):
    """Warm family + cached answers, a device kill mid-batch, the device
    rejoining: two migrations inside one fused run, only the volatile entry
    flushed, the durable answer still hitting, and the answers after the
    join exact — each as JAX's."""
    m = _jax_m()
    kill, join = [(5, 3)], [(8, 3)]
    port = _port_session(
        kernel=kernel, monitor=tfault.FleetMonitor(num_hosts=m),
        failures=tplug.FailureSchedule(kills=kill, recoveries=join))
    got = _kill_scenario(tserve, port)
    jax = _jax_session(
        kernel=kernel, monitor=jfault.FleetMonitor(num_hosts=SHARDS),
        failures=jplug.FailureSchedule(kills=kill, recoveries=join))
    want = _kill_scenario(jserve, jax)
    assert got["epoch"] == want["epoch"] == 2
    assert got["ppr_m"] == m and want["ppr_m"] == SHARDS
    assert not got["sentinel"] and got["flushed"] == 1 and got["khop_kept"]
    assert (got["sentinel"], got["flushed"], got["khop_kept"]) == \
        (want["sentinel"], want["flushed"], want["khop_kept"])
    np.testing.assert_array_equal(got["warm"], want["warm"])
    ppr_ref = _reference_column(talg.batched_ppr, 7, max_iterations=50)
    np.testing.assert_allclose(got["ppr"], ppr_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["ppr"], want["ppr"], rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_array_equal(got["sssp"][0],
                                  _reference_column(talg.batched_sssp, 3))
    _assert_same_answers("sssp", got["sssp"], want["sssp"])
    assert got["after_epoch"] == 2 and not got["after_migs"]


MIGRATION_KEYS = ("killed", "joined", "devices_before", "devices_after",
                  "device_ids", "repartitioned")


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_migration_record_reports_join(kernel):
    """The grow path labels the rejoining device in the migration record,
    as the shrink path labels the killed one — the records JAX's."""
    gj, gt = _graphs()
    m = _jax_m()
    sched = dict(kills=[(2, 4)], recoveries=[(5, 4)])
    mw = tplug.Middleware(
        gt, talg.sssp_bf(gt),
        daemon=tplug.ShardedDaemon(kernel=kernel, mesh=m,
                                   csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=m), num_shards=SHARDS,
        monitor=tfault.FleetMonitor(num_hosts=m),
        failures=tplug.FailureSchedule(**sched),
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    res = mw.run(max_iterations=REF_MAX_IT)
    migs = [r["migration"] for r in res.per_iteration if "migration" in r]
    assert len(migs) == 2
    assert migs[0]["killed"] == [4]
    assert migs[0]["devices_after"] < migs[0]["devices_before"]
    assert migs[1]["joined"] == [4]
    assert migs[1]["devices_after"] == m
    jmw = jplug.Middleware(
        gj, jalg.sssp_bf(gj), daemon="sharded", upper="mesh",
        num_shards=SHARDS, monitor=jfault.FleetMonitor(num_hosts=SHARDS),
        failures=jplug.FailureSchedule(**sched),
        options=jplug.PlugOptions(block_size=BLOCK))
    jres = jmw.run(max_iterations=REF_MAX_IT)
    jmigs = [r["migration"] for r in jres.per_iteration if "migration" in r]
    for a, b in zip(migs, jmigs, strict=True):
        for key in MIGRATION_KEYS:
            assert a[key] == b[key], (key, a[key], b[key])
    ref = tplug.run_reference(gt, talg.sssp_bf(gt), max_iterations=REF_MAX_IT,
                              device="cpu")[0]
    np.testing.assert_array_equal(res.state, ref)
    np.testing.assert_array_equal(res.state, np.asarray(jres.state))


# --------------------------------------------------------------------------
# dynamic graphs: one batch across every family, scoped invalidation
# (tests/test_mutation.py's serving contracts)
# --------------------------------------------------------------------------
def _mut_graphs():
    """(JAX graph, port graph): tests/test_mutation.py's R-MAT."""
    if "mut" not in _cache:
        gj = jgenerate.rmat(256, 2048, seed=31)
        _cache["mut"] = (gj, _port_graph(gj))
    return _cache["mut"]


def _logs(edges):
    """The same mutation log in both packages."""
    jlog, tlog = jmutation.MutationLog(), tmutation.MutationLog()
    for u, v, w in edges:
        jlog.add_edge(u, v, w)
        tlog.add_edge(u, v, w)
    return jlog, tlog


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_session_applies_one_batch_to_every_family(kernel):
    gj, gt = _mut_graphs()
    seeds = [(3,), (41,)]
    port = _port_session(gt, kernel, max_batch=4)
    jax = _jax_session(gj, kernel, max_batch=4)
    before, _ = port.execute_batch("sssp", (), seeds)
    jax.execute_batch("sssp", (), seeds)
    jlog, tlog = _logs([(3, 200, 0.5), (200, 41, 0.5)])
    dirty = port.apply_mutations(tlog)
    np.testing.assert_array_equal(dirty, [3, 41, 200])
    np.testing.assert_array_equal(dirty, jax.apply_mutations(jlog))
    after, _ = port.execute_batch("sssp", (), seeds)
    jafter, _ = jax.execute_batch("sssp", (), seeds)
    _assert_same_answers("sssp", after, [np.asarray(a) for a in jafter])
    g2, _ = tmutation.apply_to_graph(gt, tlog.freeze())
    fresh = _port_session(g2, kernel, max_batch=4)
    expect, _ = fresh.execute_batch("sssp", (), seeds)
    for a, e in zip(after, expect):
        np.testing.assert_array_equal(a, e)
    assert any(not np.array_equal(a, b) for a, b in zip(after, before))


def _answer(router, q):
    ticket, ans = router.submit(q)
    if ans is None:
        router.drain()
        ans = router.result(ticket)
    return ans


def _sssp_ref(g, seed):
    return _reference_column(talg.batched_sssp, (seed,), graph=g)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_router_mutate_catches_downstream_edge_adds(kernel):
    """An edge added downstream of the seed changes the answer, so the
    entry drops although the seed is untouched (its support caught the
    edge's source) — the record and the new answer JAX's."""
    gj, gt = _mut_graphs()
    ref_old = _sssp_ref(gt, 5)
    finite = np.flatnonzero((ref_old < np.finfo(np.float32).max)
                            & (np.arange(gt.num_vertices) != 5))
    order = finite[np.argsort(ref_old[finite])]
    u, v = int(order[len(order) // 4]), int(order[-1])
    assert ref_old[v] > ref_old[u] + 1e-3
    jlog, tlog = _logs([(u, v, 1e-3)])
    g2, _ = tmutation.apply_to_graph(gt, tlog.freeze())
    ref_new = _sssp_ref(g2, 5)
    assert not np.array_equal(ref_old, ref_new)
    out = []
    for serve, session, log in (
            (tserve, _port_session(gt, kernel, max_batch=4), tlog),
            (jserve, _jax_session(gj, kernel, max_batch=4), jlog)):
        router = serve.GraphServeRouter(session, max_batch=4)
        q = serve.Query.make("sssp", 5)
        _answer(router, q)
        router.take_results()
        rec = router.mutate(log)
        assert rec["dirty_vertices"] == 2
        assert router.cache.lookup(q.cache_key) is None
        ans = _answer(router, serve.Query.make("sssp", 5))
        assert not ans.cached
        out.append((rec, np.asarray(ans.value)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], ref_new)
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_router_mutate_scoped_by_support_spares_disjoint_entries(kernel):
    """On a two-component graph a mutation inside component A drops A's
    entry but spares B's, whose cached answer stays correct."""
    ga, gb = jgenerate.rmat(128, 1024, seed=5), jgenerate.rmat(128, 1024,
                                                               seed=6)
    gj = JGraph(256,
                np.concatenate([ga.src, gb.src + 128]).astype(np.int32),
                np.concatenate([ga.dst, gb.dst + 128]).astype(np.int32),
                np.concatenate([ga.weights, gb.weights]))
    gt = _port_graph(gj)
    jlog, tlog = _logs([(7, 30, 0.2)])
    g2, _ = tmutation.apply_to_graph(gt, tlog.freeze())
    out = []
    for serve, session, log in (
            (tserve, _port_session(gt, kernel, max_batch=4), tlog),
            (jserve, _jax_session(gj, kernel, max_batch=4), jlog)):
        router = serve.GraphServeRouter(session, max_batch=4)
        q_a, q_b = serve.Query.make("sssp", 7), serve.Query.make("sssp", 200)
        for q in (q_a, q_b):
            router.submit(q)
        router.drain()
        router.take_results()
        rec = router.mutate(log)
        assert rec["entries_dropped"] == 1
        assert router.cache.lookup(q_a.cache_key) is None
        assert router.cache.lookup(q_b.cache_key) is not None
        a = _answer(router, q_a)
        surv = _answer(router, serve.Query.make("sssp", 200))
        assert surv.cached
        out.append((rec, np.asarray(a.value), np.asarray(surv.value)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], _sssp_ref(g2, 7))
    np.testing.assert_array_equal(out[0][2], _sssp_ref(g2, 200))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_router_mutate_drops_global_lookup_entries(kernel):
    """Lookup answers read a converged global field; ANY mutation moves it,
    so the entry drops wherever the batch landed — and the new lookup is a
    fresh session's on the mutated graph, and JAX's."""
    gj, gt = _mut_graphs()
    jlog, tlog = _logs([(100, 200, 1.0)])
    out = []
    for serve, session, log in (
            (tserve, _port_session(gt, kernel, max_batch=4), tlog),
            (jserve, _jax_session(gj, kernel, max_batch=4), jlog)):
        router = serve.GraphServeRouter(session, max_batch=4)
        q = serve.Query.make("lookup", 3, field="pagerank")
        before = _answer(router, q)
        router.take_results()
        assert router.cache.lookup(q.cache_key) is not None
        rec = router.mutate(log)
        assert rec["entries_dropped"] >= 1
        assert router.cache.lookup(q.cache_key) is None
        after = _answer(router, serve.Query.make("lookup", 3,
                                                 field="pagerank"))
        assert not np.array_equal(np.asarray(before.value),
                                  np.asarray(after.value))
        out.append((rec, np.asarray(before.value), np.asarray(after.value)))
    g2, _ = tmutation.apply_to_graph(gt, tlog.freeze())
    q = tserve.Query.make("lookup", 3, field="pagerank")
    expect, _ = _port_session(g2, kernel, max_batch=4).execute_batch(
        "lookup", q.params, [q.seeds])
    np.testing.assert_allclose(out[0][2], expect[0], rtol=1e-6)
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(out[0][2], out[1][2], rtol=SUM_RTOL,
                               atol=SUM_ATOL)


# --------------------------------------------------------------------------
# parity of the pieces
# --------------------------------------------------------------------------
SEED_SETS = [[3], [3, 17, 17, (5, 9)], [(1, 2, 3), 300, -1, 255, 0, (8, 8),
                                        42, 7]]


@pytest.mark.parametrize("seeds", SEED_SETS, ids=["b1", "b4", "b8"])
@pytest.mark.parametrize("kind", list(BATCHED))
def test_batched_init_arrays_equal_jax(kind, seeds):
    gj, gt = _graphs()
    jfac, tfac = BATCHED[kind]
    jprog, tprog = jfac(gj, seeds), tfac(gt, seeds)
    for a, b in zip(tprog.init(gt), jprog.init(gj), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for f in ("name", "state_width", "aux_width", "max_iterations",
              "frontier_driven", "num_queries"):
        assert getattr(tprog, f) == getattr(jprog, f), f
    assert tprog.monoid.name == jprog.monoid.name
    assert tprog.is_batched_query() and jprog.is_batched_query()
    assert isinstance(tprog, tplug.BatchQueryCapable)


def test_batched_programs_name_their_kernel_message_function():
    want = {"khop": "add_one", "sssp": "add_weight", "ppr": "pr_div_deg"}
    assert set(talg.BATCHED_QUERIES) == set(jalg.BATCHED_QUERIES) == set(want)
    _, gt = _graphs()
    for kind, factory in talg.BATCHED_QUERIES.items():
        assert factory(gt, [1, 2]).gen_op == want[kind]
    assert not talg.pagerank(gt).is_batched_query()


def test_batched_ppr_msg_gen_divides_every_column():
    """At B = 4 the message is every column over max(a0, 1), the kernels'
    pr_div_deg — a column-0 message function fails here — and JAX's."""
    _, gt = _graphs()
    prog = talg.batched_ppr(gt, [1, 2, 3, 4])
    rng = np.random.default_rng(0)
    s = rng.random((50, 4)).astype(np.float32)
    aux = np.concatenate([rng.integers(0, 5, (50, 1)),
                          rng.random((50, 4))], 1).astype(np.float32)
    w = rng.random((50, 1)).astype(np.float32)
    got = prog.msg_gen(torch.from_numpy(s), None, torch.from_numpy(w),
                       torch.from_numpy(aux)).numpy()
    assert got.shape == (50, 4)
    np.testing.assert_array_equal(got, s / np.maximum(aux[:, :1], 1.0))
    gj, _ = _graphs()
    jgot = jalg.batched_ppr(gj, [1, 2, 3, 4]).msg_gen(s, None, w, aux)
    np.testing.assert_array_equal(got, np.asarray(jgot))


def _apply_inputs(kind, b, seed):
    """Seeded (N, B) inputs of one apply: a mid-run state, merged messages
    for about half the vertices, some queries already quiet."""
    gj, gt = _graphs()
    n = gt.num_vertices
    jprog, tprog = BATCHED[kind][0](gj, list(range(b))), \
        BATCHED[kind][1](gt, list(range(b)))
    rng = np.random.default_rng(seed)
    state, aux = tprog.init(gt)
    if kind == "ppr":
        state = rng.random((n, b)).astype(np.float32) * 1e-2
        merged = state + rng.normal(0, 1e-5, (n, b)).astype(np.float32)
    else:
        state = np.where(rng.random((n, b)) < 0.5, rng.integers(
            0, 6, (n, b)), talg.INF).astype(np.float32)
        merged = (state - rng.integers(-1, 3, (n, b))).astype(np.float32)
        merged = np.where(merged < 0, talg.INF, merged).astype(np.float32)
    quiet = rng.random(b) < 0.4  # these queries receive nothing new
    merged[:, quiet] = state[:, quiet] if kind != "ppr" else merged[:, quiet]
    if kind == "ppr":
        # a quiet PPR column's apply reproduces its state within tol
        restart = aux[:, 1:]
        merged[:, quiet] = ((state[:, quiet] - 0.15 * restart[:, quiet])
                            / 0.85)
    # PPR reads every vertex's message (a message-free row would jump to
    # the restart term and wake its query)
    has = rng.random(n) < 0.6 if kind != "ppr" else np.ones(n, bool)
    return jprog, tprog, state, merged, has, aux


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("kind", list(BATCHED))
def test_apply_step_freeze_matches_jax(kind, b, seed):
    """The per-query freeze of ``apply_step`` on seeded (N, B) inputs
    against JAX's ``make_apply_fn``: equal states (sums within rtol) and
    equal frontiers, and a frozen query's columns are its old state."""
    jprog, tprog, state, merged, has, aux = _apply_inputs(kind, b, seed)
    new, active = apply_step(tprog, torch.from_numpy(state),
                             torch.from_numpy(merged),
                             torch.from_numpy(has), torch.from_numpy(aux), 3)
    jnew, jactive = jmake_apply_fn(jprog)(state, merged, has, aux, 3)
    new, active = new.numpy(), active.numpy()
    if kind == "ppr":
        np.testing.assert_allclose(new, np.asarray(jnew), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(new, np.asarray(jnew))
    np.testing.assert_array_equal(active, np.asarray(jactive))
    # without the freeze: the program's own apply
    raw, _ = tprog.msg_apply(
        torch.from_numpy(state),
        torch.where(torch.from_numpy(has)[:, None], torch.from_numpy(merged),
                    torch.full_like(torch.from_numpy(merged),
                                    tprog.monoid.identity)),
        torch.from_numpy(has)[:, None], torch.from_numpy(aux), 3)
    q_run = tprog.query_activity(torch.from_numpy(state), raw).any(0).numpy()
    np.testing.assert_array_equal(new[:, ~q_run], state[:, ~q_run])
    np.testing.assert_array_equal(new[:, q_run], raw.numpy()[:, q_run])


def test_apply_step_freeze_fetches_nothing():
    """The freeze keeps ``q_run``, the column mask and the frontier as
    tensors: no ``item``/``bool``/``tolist``/``cpu``/``numpy`` in it."""
    _, tprog, state, merged, has, aux = _apply_inputs("ppr", 4, 0)
    args = [torch.from_numpy(x) for x in (state, merged, has, aux)]
    calls = []
    names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__", "nonzero")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def spy(name):
        def f(self, *a, **k):
            calls.append(name)
            return saved[name](self, *a, **k)
        return f

    try:
        for n in names:
            setattr(torch.Tensor, n, spy(n))
        new, active = apply_step(tprog, *args, 2)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    assert calls == []
    assert new.shape == (state.shape[0], 4) and active.dtype == torch.bool


LOOPS = {
    "host": dict(daemon="reference", upper="host"),
    "fused": dict(daemon="sharded", upper="mesh"),
    "async": dict(daemon="sharded", upper="mesh", model="async"),
    "oocore": dict(daemon="sharded", upper="mesh",
                   oocore=dict(num_super_shards=3, hot_fraction=0.3)),
}
LOOP_KIND = {"host": None, "fused": "bsp", "async": "async",
             "oocore": "oocore"}


def _loop_kw(pkg, loop, m):
    spec = dict(LOOPS[loop])
    kw = {}
    if spec.get("model") == "async":
        kw["model"] = pkg.AsyncModel(theta0=0.0, decay=0.5)
    if "oocore" in spec:
        kw["oocore"] = pkg.OocoreConfig(**spec["oocore"])
    if spec["daemon"] == "sharded":
        if pkg is tplug:
            kw["daemon"] = tplug.ShardedDaemon(kernel="reference", mesh=m,
                                               csr_config=CSRConfig())
            kw["upper"] = tplug.MeshUpperSystem(mesh=m)
        else:
            kw["daemon"], kw["upper"] = "sharded", "mesh"
    else:
        kw["daemon"], kw["upper"] = spec["daemon"], spec["upper"]
    return kw


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_freeze_in_every_drive_loop_matches_jax(loop, kind):
    """A batch with a duplicate and a multi-seed query through each drive
    loop against JAX's same loop: the loop the port chose, the iterations,
    and the state (sums within rtol).  For PPR the freeze changes the
    state, so a loop that skipped it would disagree."""
    gj, gt = _graphs()
    seeds = [7, (1, 2), 7, 40]
    m = _jax_m()
    jfac, tfac = BATCHED[kind]
    mw = tplug.Middleware(gt, tfac(gt, seeds), num_shards=SHARDS,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu", **_loop_kw(tplug, loop, m))
    assert mw._fused_kind == LOOP_KIND[loop]
    res = mw.run()
    jmw = jplug.Middleware(gj, jfac(gj, seeds), num_shards=SHARDS,
                           options=jplug.PlugOptions(block_size=BLOCK),
                           **_loop_kw(jplug, loop, m))
    jres = jmw.run()
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    if kind == "ppr":
        np.testing.assert_allclose(res.state, np.asarray(jres.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
        # the unmasked reference takes other steps: the freeze ran
        ref = tplug.run_reference(gt, tfac(gt, seeds), device="cpu")[0]
        assert not np.array_equal(res.state, ref)
        np.testing.assert_allclose(res.state, ref, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(res.state, np.asarray(jres.state))
    np.testing.assert_array_equal(res.state[:, 0], res.state[:, 2])


# --------------------------------------------------------------------------
# exports, refusals and the launcher
# --------------------------------------------------------------------------
def test_serve_exports_what_jax_exports():
    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None
    assert tserve.BATCH_KINDS == jserve.BATCH_KINDS
    assert tserve.LOOKUP_FIELDS == jserve.LOOKUP_FIELDS
    assert "BatchQueryCapable" in tplug.__all__
    assert tplug.BatchQueryCapable is not None


@pytest.mark.parametrize("seed", [0, 1])
def test_answer_deps_equal_jax(seed):
    from repro.serve.session import answer_deps as janswer_deps
    from repro_torch.serve.session import answer_deps

    rng = np.random.default_rng(seed)
    v = np.where(rng.random(64) < 0.3, talg.INF,
                 rng.random(64)).astype(np.float32)
    p = np.where(rng.random(64) < 0.5, 0.0, rng.random(64)).astype(
        np.float32)
    for kind, value, seeds in (("sssp", v, (3, 9)), ("khop", v, 5),
                               ("ppr", p, (1,)), ("lookup", p, (2,))):
        got, want = answer_deps(kind, seeds, value), janswer_deps(
            kind, seeds, value)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_cuda_kernel_refuses_batches_over_k16():
    _, gt = _graphs()
    with pytest.raises(ValueError, match="K <= 16"):
        tserve.GraphServeSession(gt, kernel="cuda", max_batch=32,
                                 device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tserve.GraphServeSession(gt, max_batch=6, device="cpu")
    # 16 is the kernel's widest K, and the reference body takes any width
    tserve.GraphServeSession(gt, kernel="cuda", max_batch=16, device="cpu")
    tserve.GraphServeSession(gt, kernel="reference", max_batch=32,
                             device="cpu")


def test_entry_points_refuse_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = _graphs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.GraphServeSession(gt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_serve.main(["--num-vertices", "64", "--num-edges", "256",
                          "--requests", "4"])


def test_launcher_serves_on_the_cpu(capsys):
    stats = graph_serve.main([
        "--device", "cpu", "--num-vertices", "300", "--num-edges", "2400",
        "--requests", "24", "--rate", "400", "--mesh", "4",
        "--kill-at", "2", "--kill-device", "1", "--recover-at", "4"])
    assert stats["completed"] == 24
    out = capsys.readouterr().out
    assert "device cpu" in out and "kernel=cuda" in out
    assert "qps" in out and "p99" in out
