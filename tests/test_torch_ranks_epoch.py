"""Structure epochs across ``torch.distributed`` ranks on the CPU: kills,
joins, stragglers, rebalance and graph mutations over W gloo ranks
(``dist.sharding.RankMesh``) against the port's single-process ``mesh=m``,
``run_reference`` and the JAX package's fused loop.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous in a temporary directory): 4 ranks × 1 logical
device and 2 × 2 over 4 shards, 4 × 2 over 8 shards.  Every rank runs the
cases of ``torch_ranks_worker.all_epoch_cases`` (tests/torch_ranks_worker.py)
and its share of the same cases at ``mesh=m``:

* ``FailureSchedule`` kills of the last device (a 2 × 2 world keeps
  devices 0 and 1, both on rank 0: rank 1 sits the run out) under GAS and
  pagerank BSP, of device 1 (2 × 2: devices 0 and 2, one a rank), a kill
  and a join back (GAS, async ``holding``), a straggler's Lemma-2
  re-partition — each run twice, the second on the structure the first
  left (idle ranks sit it out from its start);
* ``rebalance(capacities=)`` between runs, ``run_dynamic`` with an
  add-only batch (incremental, mode ``"dirty"``) and with removals
  (``"cold_fallback"``), a mid-run ``MutationSchedule`` batch (GAS and
  async ``holding``), and the host loop's ``run_dynamic``.

Each run is held to the one-process run at the same m: min programs bit
for bit with equal records (migration and mutation records but their
``seconds``, blocks run per shard, active counts, the async fields),
pagerank within rtol 1e-5 / atol 1e-6 and one iteration; every rank's
``Result`` bit-identical to rank 0's, idle ranks included; the scheduled
cases also against JAX's fused loop (``kernel="pallas"`` at the
counterpart config), whose m (over 8 CPU devices) must equal the world's
(state, iterations, migration records).
"""
import concurrent.futures
import multiprocessing
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_ranks_worker as worker  # noqa: E402
from repro import plug as jplug  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.dist.sharding import RankMesh  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from test_torch_async import ARMS  # noqa: E402
from test_torch_fault import MIGRATION_KEYS  # noqa: E402
from test_torch_fused import (SUM_ATOL, SUM_RTOL, _graph,  # noqa: E402
                              _jax_daemon)
from test_torch_ranks import world_of_one  # noqa: E402,F401

WORLDS = {"4x1": (4, 1, 4), "2x2": (2, 2, 4), "4x2": (4, 2, 8)}
WORLD_TIMEOUT_S = 150.0
CASE_NAMES = [c[:3] for c in worker.all_epoch_cases(4)]


def _mutations():
    """An add-only batch (6 random edges) and a removal batch (4 edges of
    the graph), as ``(u, v)`` pairs."""
    g = _graph("sssp_bf")[1]
    rng = np.random.default_rng(7)
    adds = [tuple(int(x) for x in rng.integers(0, g.num_vertices, 2))
            for _ in range(6)]
    removes = [(int(g.src[e]), int(g.dst[e]))
               for e in rng.choice(g.num_edges, 4, replace=False)]
    return adds, removes


def _jax_scheduled(case, shards):
    """JAX's fused loop under a scheduled case → (state, iterations,
    migration records, JAX's m before the run's epochs)."""
    _, prog_name, model, sched = case
    gj, _ = _graph(prog_name)
    mw = jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj),
        daemon=_jax_daemon("cuda"), upper="mesh",
        model=(jplug.AsyncModel(**ARMS[model]) if model in ARMS else model),
        num_shards=shards, failures=jplug.FailureSchedule(**sched),
        options=jplug.PlugOptions(block_size=worker.BLOCK))
    m = mw.daemon.m
    res = mw.run(max_iterations=worker.max_it(prog_name))
    migs = [{k: r["migration"][k] for k in MIGRATION_KEYS}
            for r in res.per_iteration if "migration" in r]
    return np.asarray(res.state), res.iterations, migs, m


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank results and JAX's scheduled runs by (case,
    shards)."""
    tmp = tmp_path_factory.mktemp("ranks_epoch")
    graphs = {"directed": _graph("sssp_bf")[1], "wcc": _graph("wcc")[1]}
    mutations = _mutations()
    spawn = multiprocessing.get_context("spawn")
    jax_cases = {(c[:3], s): (c, s)
                 for w, local, s in WORLDS.values()
                 for c in worker.epoch_cases(w * local)}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                3, mp_context=spawn) as procs:
        futures = {
            name: threads.submit(spawn_ranks, worker.epoch_world, w,
                                 (graphs, s, local, mutations),
                                 backend="gloo",
                                 init_method=f"file://{tmp}/{name}",
                                 timeout_s=WORLD_TIMEOUT_S)
            for name, (w, local, s) in WORLDS.items()}
        jax = {k: procs.submit(_jax_scheduled, *v)
               for k, v in jax_cases.items()}
        jax = {k: f.result(timeout=WORLD_TIMEOUT_S) for k, f in jax.items()}
        ranks = {name: f.result() for name, f in futures.items()}
    return ranks, jax


def _rank_runs(ranks, key):
    """Every rank's runs of ``key``, after checking they are replicated —
    bit-identical states, equal iterations, stats and records, the
    survivor group — and that a rank's devices are those of the group."""
    runs = [r["ranks"][key] for r in ranks]
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            assert a["state"].tobytes() == b["state"].tobytes()
            for f in ("iterations", "converged", "stats", "records",
                      "members", "epoch", "last_restart", "m"):
                assert a[f] == b[f], f
    for r, rank_runs in zip(ranks, runs):
        for run in rank_runs:
            assert (run["local"] > 0) == (r["rank"] in run["members"])
    return runs[0]


def _single(ranks, key):
    return next(r["single"][key] for r in ranks if key in r["single"])


def _migrations(run):
    return [r["migration"] for r in run["records"] if "migration" in r]


def _assert_same(prog_name, got, want):
    assert got["m"] == want["m"]
    assert got["epoch"] == want["epoch"]
    assert got["last_restart"] == want["last_restart"]
    if prog_name in worker.SUM_PROGRAMS:
        np.testing.assert_allclose(got["state"], np.asarray(want["state"]),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
        assert abs(got["iterations"] - want["iterations"]) <= 1
        assert _migrations(got) == _migrations(want)
        return
    np.testing.assert_array_equal(got["state"], np.asarray(want["state"]))
    assert (got["iterations"], got["converged"], got["stats"]) == \
        (want["iterations"], want["converged"], want["stats"])
    assert got["records"] == want["records"]


def _reference(prog_name):
    g = _graph(prog_name)[1]
    return tplug.run_reference(g, talg.ALGORITHMS[prog_name](g),
                               device="cpu")[0]


def test_children_import_nothing_of_jax(worlds):
    ranks, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            assert r["imports"] == [], (name, r["rank"], r["imports"])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", CASE_NAMES, ids="-".join)
def test_epochs_across_ranks_equal_one_process(worlds, case, world):
    ranks, _ = worlds
    got = _rank_runs(ranks[world], case)
    want = _single(ranks[world], case)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _assert_same(case[1], a, b)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", [c[:3] for c in worker.epoch_cases(4)],
                         ids="-".join)
def test_scheduled_epochs_match_jax(worlds, case, world):
    ranks, jax = worlds
    w, local, s = WORLDS[world]
    got = _rank_runs(ranks[world], case)[0]
    state, iterations, migs, jax_m = jax[case, s]
    assert jax_m == w * local
    assert [{k: m[k] for k in MIGRATION_KEYS} for m in _migrations(got)] \
        == migs
    if case[1] in worker.SUM_PROGRAMS:
        np.testing.assert_allclose(got["state"], state, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
        assert abs(got["iterations"] - iterations) <= 1
    else:
        np.testing.assert_array_equal(got["state"], state)
        assert got["iterations"] == iterations


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_a_kill_of_the_last_device_idles_ranks(worlds, world):
    """m → m′ (the largest divisor of S the survivors host), the lowest
    m′ devices kept: the ranks beyond them sit out both runs, and return
    the same ``Result``; sssp_bf reaches run_reference's fixed point."""
    ranks, _ = worlds
    w, local, s = WORLDS[world]
    m = w * local
    first, second = _rank_runs(ranks[world], ("kill_last", "sssp_bf", "gas"))
    (mig,) = _migrations(first)
    keep = max(d for d in range(1, m) if s % d == 0)
    assert mig["killed"] == [m - 1] and mig["device_ids"] == list(range(keep))
    assert first["members"] == second["members"] == \
        sorted({d // local for d in range(keep)})
    assert len(first["members"]) < w
    assert not _migrations(second)
    for run in (first, second):
        np.testing.assert_array_equal(run["state"], _reference("sssp_bf"))


def test_non_uniform_survivors_in_a_2x2_world(worlds):
    """2 × 2 loses device 1: m′ = 2 on devices 0 and 2 — one on each rank;
    losing device 3 keeps 0 and 1, both on rank 0 (rank 1 idle)."""
    ranks, _ = worlds
    first, _ = _rank_runs(ranks["2x2"], ("kill_1", "sssp_bf", "gas"))
    (mig,) = _migrations(first)
    assert mig["device_ids"] == [0, 2] and first["members"] == [0, 1]
    assert [r["ranks"]["kill_1", "sssp_bf", "gas"][0]["local"]
            for r in ranks["2x2"]] == [1, 1]
    first, _ = _rank_runs(ranks["2x2"], ("kill_last", "sssp_bf", "gas"))
    assert first["members"] == [0]
    assert [r["ranks"]["kill_last", "sssp_bf", "gas"][0]["local"]
            for r in ranks["2x2"]] == [2, 0]


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("model", ["gas", "holding"])
def test_a_join_brings_idle_ranks_back(worlds, model, world):
    """Device 1 dies before iteration 2 and is back before iteration 4:
    m → m′ → m, the ranks outside the survivors' group rejoin and finish
    the run, at run_reference's fixed point."""
    ranks, _ = worlds
    w, local, _ = WORLDS[world]
    first, _ = _rank_runs(ranks[world], ("kill_join", "sssp_bf", model))
    kill, join = _migrations(first)
    assert kill["killed"] == [1] and join["joined"] == [1]
    assert join["devices_after"] == w * local
    assert first["members"] == list(range(w))
    np.testing.assert_array_equal(first["state"], _reference("sssp_bf"))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_straggler_repartitions_across_ranks(worlds, world):
    ranks, _ = worlds
    w, local, _ = WORLDS[world]
    first, second = _rank_runs(ranks[world], ("straggler", "sssp_bf", "gas"))
    (mig,) = _migrations(first)
    assert mig["stragglers"] == [w * local - 2] and mig["repartitioned"]
    assert not _migrations(second)
    np.testing.assert_array_equal(first["state"], _reference("sssp_bf"))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_mutations_across_ranks(worlds, world):
    """run_dynamic's restart modes and the mid-run batch's record, on the
    ranks as on one process."""
    ranks, _ = worlds
    modes = {name: _rank_runs(ranks[world], (name, "sssp_bf", model))[1]
             ["last_restart"]["mode"]
             for name, model in (("dynamic_add", "gas"),
                                 ("dynamic_remove", "gas"),
                                 ("host_dynamic", "bsp"))}
    assert modes == {"dynamic_add": "dirty",
                     "dynamic_remove": "cold_fallback",
                     "host_dynamic": "dirty"}
    for model in ("gas", "holding"):
        first, _ = _rank_runs(ranks[world], ("midrun_add", "sssp_bf", model))
        (mut,) = [r["mutation"] for r in first["records"] if "mutation" in r]
        assert mut["incremental"] and mut["edges_added"] > 0
        assert first["records"][1]["mutation"] == mut


def test_rebalance_fractions_are_every_ranks(worlds):
    for world in WORLDS:
        ranks, _ = worlds
        fr = [r["ranks"]["rebalance", "sssp_bf", "gas"][0]["fractions"]
              for r in ranks[world]]
        assert all(f == fr[0] for f in fr)
        assert fr[0] == _single(ranks[world], ("rebalance", "sssp_bf",
                                               "gas"))[0]["fractions"]
        assert fr[0][0] < fr[0][1]  # shard 0 at half capacity


def test_survivor_mesh_of_one_rank(world_of_one):
    """A world of one rank × 2 devices: the survivor mesh of device 1
    keeps the rank (its one device owns every shard), reuses the world's
    group, and bad device lists raise before any group is made; a merge
    across ranks re-meshes onto a RankMesh only."""
    rm = RankMesh(local=2, device="cpu")
    one = rm.survivors([1])
    assert (one.size, one.local, one.offset, one.members) == (1, 1, 0, (0,))
    assert one.group is rm.group and not one.idle
    assert one.shard_range(4) == range(4) and rm.shard_range(4) == range(4)
    for bad in ([], [2], [1, 1], [-1]):
        with pytest.raises(ValueError, match="survivor devices"):
            rm.survivors(bad)
    g = _graph("sssp_bf")[1]
    upper = tplug.MeshUpperSystem(mesh=rm).bind(talg.sssp_bf(g), 4,
                                                device="cpu")
    with pytest.raises(ValueError, match="RankMesh"):
        upper.remesh(2)
    assert upper.remesh(one).m == 1 and upper.joined == ()
