"""Out-of-core execution across ``torch.distributed`` ranks on the CPU:
``Middleware(oocore=...)`` over W gloo ranks (``dist.sharding.RankMesh``),
each streaming its own shards' columns of every super-shard, against the
port's single-process ``mesh=m`` run and the JAX package's
``OocoreDriveLoop`` at JAX's m.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous in a temporary directory): 4 ranks × 1 logical
device and 2 × 2 over 4 shards, 4 × 2 over 8.  Every rank runs the cases
of ``torch_ranks_worker.oocore_cases`` (tests/torch_ranks_worker.py) and
its share of the same cases at ``mesh=m``; JAX's runs go on meanwhile in
three processes:

* the bit-identity matrix (hot fraction {0, 0.25} × groups {2, 3} ×
  prefetch on/off) for sssp_bf GAS through both bodies (``kernel="cuda"``'s
  plain twin at ``CSRConfig()``, and ``"reference"``): states bit-equal and
  equal iterations; per record ``super_shards`` and ``hot_cols`` JAX's, the
  world's ``hot_hits`` and ``cold_misses`` the one-process run's; one small
  fetch an iteration on each rank, at most two groups live;
* a byte budget: the plan JAX's planner's on the world's (num_cols,
  col_bytes), and JAX's own where the columns weigh the same (the block
  body);
* pagerank within rtol 1e-5 / atol 1e-6;
* frontier skipping on ``grid_road(48)``: every group the one-process run
  skipped is skipped on every rank;
* a kill of the last device before iteration 3 (2 × 2: rank 1 idle; 4 × 1
  and 4 × 2: ranks 2–3), then ``oocore_replan`` at half the budget and a
  second run: idle ranks return the leader's ``Result`` and hold no group;
* ``csr_config=None``: one sweep in the world, one config on every rank,
  out of core and resident.

Every rank's ``Result`` (state, iterations, records but the rank's own
``skipped``) is bit-identical to rank 0's.
"""
import concurrent.futures
import dataclasses
import multiprocessing
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_ranks_worker as worker  # noqa: E402
from repro import oocore as joocore  # noqa: E402
from repro import plug as jplug  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import generate as jgenerate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from test_torch_fused import SUM_ATOL, SUM_RTOL, _jax_daemon  # noqa: E402

WORLDS = {"4x1": (4, 1, 4), "2x2": (2, 2, 4), "4x2": (4, 2, 8)}
WORLD_TIMEOUT_S = 150.0
# the worlds held to JAX's runs (its m over 4 shards is theirs); the 4 × 2
# world over 8 shards is held to the one-process run alone, for time
JAX_WORLDS = ("2x2", "4x1")
CASES = worker.oocore_cases()
CASE_KEYS = [c[:2] for c in CASES]
# the counters every rank and one process agree on (``skipped`` is a
# rank's own)
WORLD_COUNTERS = ("super_shards", "hot_cols", "prefetch", "hot_hits",
                  "cold_misses")
# JAX's column weighs what the port's does only for the block body (the
# CSR body streams the fields it reads): a budget case is held to JAX's
# trajectory there alone
JAX_SAME_PLAN = {"reference"}

_graphs: dict = {}


def _graph(key):
    """(JAX graph, port graph): the worker's ``directed`` R-MAT (the
    fused tests'), a denser one with several CSR tiles a shard, and the
    road lattice."""
    if key not in _graphs:
        gj = {"directed": lambda: jgenerate.rmat(256, 2048, seed=9),
              "dense": lambda: jgenerate.rmat(512, 16384, seed=7),
              "road": lambda: jgenerate.grid_road(48, seed=3)}[key]()
        _graphs[key] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[key]


def _budgets(shards, m) -> dict:
    """The resident column bytes per logical device of each body's graph
    at ``mesh=m`` (the port's one-process stack)."""
    out = {}
    for kernel in worker.OOCORE_KERNELS:
        _, g = _graph(worker.OOCORE_GRAPH[kernel])
        mw = worker.oocore_middleware(g, "sssp_bf", kernel, shards, m, None)
        st = mw.daemon.stacked
        st = (st["csr"] if kernel == "cuda" else
              {k: st[k] for k in ("vids", "lsrc", "ldst", "weights",
                                  "emask", "gsrc")})
        out[kernel] = sum(t.numel() * t.element_size()
                          for t in st.values()) // mw.daemon.m
    return out


def _jax_case(case, shards, budget):
    """JAX's out-of-core run of a case (the kill case's first run) →
    (state, iterations, counters, plan, JAX's m)."""
    name, kernel, prog_name, oc = case
    gj, _ = _graph(worker.oocore_graph(name, kernel))
    oc = dict(oc)
    if "budget" in oc:
        oc["hbm_budget"] = budget // oc.pop("budget")
    kw = {}
    if name == ("kill",):
        kw["failures"] = jplug.FailureSchedule(kills=[(3, shards - 1)])
    mw = jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon(kernel),
        upper="mesh", model="bsp" if prog_name == "pagerank" else "gas",
        num_shards=shards, oocore=jplug.OocoreConfig(**oc),
        options=jplug.PlugOptions(block_size=worker.BLOCK), **kw)
    m = mw.daemon.m
    plan = dataclasses.asdict(mw.daemon.oocore_plan)
    cap = (worker.ROAD_ITERATIONS if name == ("road",)
           else worker.max_it(prog_name))
    res = mw.run(max_iterations=cap)
    counters = [{k: r["oocore"][k] for k in worker.OOCORE_COUNTERS}
                for r in res.per_iteration]
    return np.asarray(res.state), res.iterations, counters, plan, m


def _jax_cases():
    return [c for c in CASES if c[0][0] != "autotune"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank results, the budgets they ran at, and JAX's
    runs by (case, shards)."""
    tmp = tmp_path_factory.mktemp("ranks_oocore")
    graphs = {k: _graph(k)[1] for k in ("directed", "dense", "road")}
    budgets = {name: _budgets(s, w * local)
               for name, (w, local, s) in WORLDS.items()}
    spawn = multiprocessing.get_context("spawn")
    jax_cases = {(c[:2], s): (c, s, budgets[name][c[1]])
                 for name in JAX_WORLDS for c in _jax_cases()
                 for s in [WORLDS[name][2]]}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                3, mp_context=spawn) as procs:
        futures = {
            name: threads.submit(spawn_ranks, worker.oocore_world, w,
                                 (graphs, s, local, budgets[name]),
                                 backend="gloo",
                                 init_method=f"file://{tmp}/{name}",
                                 timeout_s=WORLD_TIMEOUT_S)
            for name, (w, local, s) in WORLDS.items()}
        jax = {k: procs.submit(_jax_case, *v) for k, v in jax_cases.items()}
        jax = {k: f.result(timeout=WORLD_TIMEOUT_S) for k, f in jax.items()}
        ranks = {name: f.result() for name, f in futures.items()}
    return ranks, jax, budgets


def _world(counters):
    return [{k: c[k] for k in WORLD_COUNTERS} for c in counters]


def _rank_runs(ranks, key):
    """Every rank's runs of ``key``, after checking they are replicated:
    bit-identical states, equal iterations, records and world counters,
    the same survivor group."""
    runs = [r["ranks"][key] for r in ranks]
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            assert a["state"].tobytes() == b["state"].tobytes()
            for f in ("iterations", "converged", "records", "members",
                      "epoch", "m"):
                assert a[f] == b[f], f
            assert _world(a["counters"]) == _world(b["counters"])
    return runs


def _single(ranks, key):
    return next(r["single"][key] for r in ranks if key in r["single"])


def _assert_same(prog_name, got, want):
    if prog_name in worker.SUM_PROGRAMS:
        np.testing.assert_allclose(got["state"], want["state"],
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got["state"], want["state"])
    assert (got["iterations"], got["converged"]) == \
        (want["iterations"], want["converged"])


def _reference(key, prog_name):
    _, g = _graph(key)
    return tplug.run_reference(g, talg.ALGORITHMS[prog_name](g),
                               device="cpu")[0]


def test_children_import_nothing_of_jax(worlds):
    ranks, _, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            assert r["imports"] == [], (name, r["rank"], r["imports"])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("key", [k for k in CASE_KEYS if k[0][0] != "autotune"],
                         ids=lambda k: "-".join(map(str, k[0])) + "-" + k[1])
def test_oocore_across_ranks_equals_one_process(worlds, key, world):
    """Each run bit-equal (pagerank within tolerance) to the one-process
    ``mesh=m`` run, with equal plans, records and world counters; every
    group one process skipped is skipped on every rank."""
    ranks, _, _ = worlds
    case = next(c for c in CASES if c[:2] == key)
    runs = _rank_runs(ranks[world], key)
    want = _single(ranks[world], key)
    assert len(runs[0]) == len(want)
    for i, w in enumerate(want):
        got = runs[0][i]
        _assert_same(case[2], got, w)
        assert got["records"] == w["records"]
        assert _world(got["counters"]) == _world(w["counters"])
        for rank_runs in runs:
            run = rank_runs[i]
            if run["local"] == 0:  # idle: the leader's Result
                continue
            assert run["plan"] == w["plan"]
            for mine, one in zip(run["verdicts"], w["verdicts"]):
                assert set(one or ()) <= set(mine or ()), (mine, one)
            assert 0 < run["max_live_groups"] <= 2 or not run["plan"][
                "num_super_shards"]


@pytest.mark.parametrize("world", JAX_WORLDS)
@pytest.mark.parametrize("key", [c[:2] for c in _jax_cases()],
                         ids=lambda k: "-".join(map(str, k[0])) + "-" + k[1])
def test_oocore_across_ranks_matches_jax(worlds, key, world):
    """The state and iterations of JAX's out-of-core loop at JAX's m (the
    world's), and its per-record ``super_shards``, ``hot_cols``, hot hits
    and cold misses where the two packages cut the same plan."""
    ranks, jax, _ = worlds
    w, local, s = WORLDS[world]
    case = next(c for c in CASES if c[:2] == key)
    got = _rank_runs(ranks[world], key)[0][0]
    state, iterations, counters, plan, jax_m = jax[key, s]
    assert jax_m == w * local
    _assert_same(case[2], got, {"state": state, "iterations": iterations,
                                "converged": got["converged"]})
    if "budget" in case[3] and key[1] not in JAX_SAME_PLAN:
        return
    mine = _world(got["counters"])
    want = _world(counters)
    if key[0] == ("kill",):
        # the kill's migration lands before iteration 3, which the port
        # runs on every group (its verdicts ride the step's fetch)
        assert len(mine) == len(want)
    assert mine == want
    if key[0] != ("kill",):
        # a CSR column weighs what the fields it streams weigh
        weight = () if key[1] in JAX_SAME_PLAN else ("col_bytes_dev",)
        assert {k: v for k, v in got["plan"].items() if k not in weight} \
            == {k: v for k, v in plan.items() if k not in weight}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_matrix_fetches_once_an_iteration_on_each_rank(worlds, world):
    """One small fetch a step on every rank, and one vertex-sized one (the
    final state)."""
    ranks, _, _ = worlds
    for key in CASE_KEYS:
        if key[0][0] != "matrix":
            continue
        for r in ranks[world]:
            (run,) = r["ranks"][key]
            n = run["state"].shape[0]
            small = [c for c in run["fetches"] if c[1] < n]
            big = [c for c in run["fetches"] if c[1] >= n]
            assert [c[0] for c in small] == ["tolist"] * run["iterations"]
            assert big == [("cpu", run["state"].size)]
            assert run["verdicts"] and len(run["counters"]) == \
                run["iterations"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_byte_budget_plan_is_the_world_plan(worlds, world):
    """Under a byte budget every rank plans JAX's planner's plan on the
    world's (num_cols, col_bytes_dev), a column costing S/m shards', and
    the block body's plan is JAX's middleware's."""
    ranks, jax, budgets = worlds
    w, local, s = WORLDS[world]
    for kernel in worker.OOCORE_KERNELS:
        key = (("budget",), kernel)
        runs = _rank_runs(ranks[world], key)
        plan = runs[0][0]["plan"]
        assert all(r[0]["plan"] == plan for r in runs)
        assert plan["num_super_shards"] > 0 and not plan["fits_resident"]
        want = joocore.plan_super_shards(
            plan["num_cols"], plan["col_bytes_dev"], joocore.OocoreConfig(
                hbm_budget=budgets[world][kernel] // 3, hot_fraction=0.25))
        assert plan == dataclasses.asdict(want)
        if kernel in JAX_SAME_PLAN and world in JAX_WORLDS:
            assert plan == jax[key, s][3]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_road_skips_across_ranks(worlds, world):
    """On the road lattice the groups one process skips are skipped on
    every rank (a rank may skip more), and the skips are free: the state
    is the resident run's."""
    ranks, _, _ = worlds
    key = (("road",), "reference")
    runs = _rank_runs(ranks[world], key)
    one = _single(ranks[world], key)[0]
    assert sum(len(v or ()) for v in one["verdicts"]) > 0
    for rank_runs in runs:
        run = rank_runs[0]
        assert sum(c["skipped"] for c in run["counters"]) >= \
            sum(c["skipped"] for c in one["counters"])
    ref = tplug.run_reference(
        _graph("road")[1], talg.sssp_bf(_graph("road")[1]),
        max_iterations=worker.ROAD_ITERATIONS, device="cpu")[0]
    np.testing.assert_array_equal(runs[0][0]["state"], ref)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kernel", worker.OOCORE_KERNELS)
def test_kill_then_replan_idles_ranks(worlds, kernel, world):
    """The last device dies before iteration 3: the survivors re-plan for
    the shorter axis (a column's per-device bytes grow), the ranks beyond
    them sit out and hold no group, and after ``oocore_replan`` at half the
    budget a second run answers the same; every rank's ``Result`` the
    same, at ``run_reference``'s fixed point."""
    ranks, _, _ = worlds
    w, local, s = WORLDS[world]
    m = w * local
    key = (("kill",), kernel)
    first, second = _rank_runs(ranks[world], key)[0]
    (mig,) = [r["migration"] for r in first["records"] if "migration" in r]
    keep = max(d for d in range(1, m) if s % d == 0)
    assert mig["killed"] == [m - 1] and mig["device_ids"] == list(range(keep))
    assert first["members"] == second["members"] == \
        sorted({d // local for d in range(keep)})
    assert len(first["members"]) < w
    assert first["plan"]["col_bytes_dev"] > 0
    one = _single(ranks[world], key)
    assert second["replan"] == one[1]["replan"]
    assert second["replan"]["hot_cols_after"] <= \
        second["replan"]["hot_cols_before"]
    ref = _reference(worker.OOCORE_GRAPH[kernel], "sssp_bf")
    for run in (first, second):
        np.testing.assert_array_equal(run["state"], ref)
    for r in ranks[world]:
        for run in r["ranks"][key]:
            if r["rank"] not in run["members"]:
                assert run["local"] == 0 and run["plan"] is None
                assert run["groups_held"] == 0 and not run["hot_held"]
                assert run["max_live_groups"] == 0
        idle_replan = r["ranks"][key][1]["replan"]
        if r["rank"] not in second["members"]:
            assert idle_replan["super_shards_after"] is None


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("resident", [False, True])
def test_unpinned_config_sweeps_once_in_the_world(worlds, resident, world):
    """``csr_config=None``: the rank holding the world's largest shard
    sweeps, the others bind its winner — one sweep, one config — out of
    core and resident; the answer is run_reference's."""
    ranks, _, _ = worlds
    key = (("autotune", "resident") if resident else ("autotune",), "cuda")
    runs = _rank_runs(ranks[world], key)
    assert sum(r[0]["sweeps"] for r in runs) == 1
    assert len({repr(r[0]["config"]) for r in runs}) == 1
    np.testing.assert_array_equal(runs[0][0]["state"],
                                  _reference("dense", "sssp_bf"))
    assert (runs[0][0]["plan"] is None) == resident
