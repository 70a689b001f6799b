"""The graph loop across ``torch.distributed`` ranks on the CPU: W gloo
ranks over ``dist.sharding.RankMesh`` against the JAX package's loops and
the port's single-process ``mesh=m``.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous in a temporary directory): 4 ranks × 1 logical
device and 2 × 2 over 4 shards, 4 × 2 over 8 shards.  Every rank runs
sssp_bf, bfs, wcc, pagerank and label_prop under BSP and GAS through the
fused ``DriveLoop`` and through the ``HostDriveLoop``
(tests/torch_ranks_worker.py), pagerank's host loop on the compressed wire
(bits 8 and 4), the rank wire itself, and the compositions a RankMesh does
not reach yet; its share of the same cases at the single-process
``mesh=m``.  The JAX oracles run here in the parent meanwhile.

* min programs bit for bit, with equal iterations, records (``blocks_run``
  per shard, ``skipped``, ``active``) and ``SyncStats``; sums within
  rtol 1e-5 / atol 1e-6 (the all_reduce adds the ranks' partials in its own
  order); ``wire_stats`` as the JAX package counts them at the same m;
* every rank's final state is bit-identical to rank 0's;
* the compressed host loop equals the single-process one bit for bit, and
  the rank wire (bits 8 and 4, both formats) equals the stacked wire at m
  and its oracle bit for bit;
* bad meshes raise ``ValueError``; the MoE under a RankMesh takes the
  local path, as in the JAX package; a bad monitor or mutation schedule
  fails as on one process.
"""
import concurrent.futures
import datetime
import multiprocessing
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks_worker as worker
from repro import plug as jplug
from repro.graph import algorithms as jalg
from repro_torch import plug as tplug
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import RankMesh
from repro_torch.graph import algorithms as talg
from repro_torch.launch.mesh import make_rank_mesh, spawn_ranks
from repro_torch.plug.protocols import divisor_mesh, shard_range
from test_torch_collectives import _host_int8_wire
from test_torch_fused import SUM_ATOL, SUM_RTOL, _graph, _jax_run

WORLDS = {"4x1": (4, 1, 4), "2x2": (2, 2, 4), "4x2": (4, 2, 8)}
FUSED_KEYS = ("blocks_total", "blocks_run", "shard_blocks_run", "active")
HOST_KEYS = ("blocks_total", "blocks_run", "shard_entities", "skipped",
             "active")
WORLD_TIMEOUT_S = 150.0

def _jax_host(prog_name, model, shards):
    """JAX's host loop over its mesh upper system → (the run as
    ``worker._run_record`` gives it, JAX's m, its ``wire_stats``)."""
    gj, _ = _graph(prog_name)
    mw = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                          daemon="vectorized", upper="mesh", model=model,
                          num_shards=shards,
                          options=jplug.PlugOptions(block_size=worker.BLOCK))
    assert mw._fused_kind is None
    res = mw.run(max_iterations=worker.max_it(prog_name))
    return worker._run_record(res), mw.upper.m, dict(mw.upper.wire_stats)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank results, and the JAX oracles by (loop,
    program, [model,] shards).  The worlds run in their processes, JAX's
    host loops in two more, while this process runs JAX's fused loops."""
    tmp = tmp_path_factory.mktemp("ranks")
    graphs = {"directed": _graph("sssp_bf")[1], "wcc": _graph("wcc")[1]}
    sizes = sorted({s for _, _, s in WORLDS.values()})
    host_cases = [(p, m, s) for s in sizes for p in worker.PROGRAMS
                  for m in worker.MODELS]
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 3) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                2, mp_context=spawn) as procs:
        futures = {
            name: threads.submit(spawn_ranks, worker.cpu_world, w,
                                 (graphs, s, local), backend="gloo",
                                 init_method=f"file://{tmp}/{name}",
                                 timeout_s=WORLD_TIMEOUT_S)
            for name, (w, local, s) in WORLDS.items()}
        example = threads.submit(spawn_ranks, worker.example_world, 2,
                                 backend="gloo",
                                 init_method=f"file://{tmp}/example",
                                 timeout_s=WORLD_TIMEOUT_S)
        # worlds that must fail: a rank raising, a rank hanging
        failing = threads.submit(spawn_ranks, worker.failing_entry, 2,
                                 backend="gloo",
                                 init_method=f"file://{tmp}/fail",
                                 timeout_s=WORLD_TIMEOUT_S)
        hanging = threads.submit(spawn_ranks, worker.hanging_entry, 1,
                                 backend="gloo",
                                 init_method=f"file://{tmp}/hang",
                                 timeout_s=1.0)
        host = {case: procs.submit(_jax_host, *case) for case in host_cases}
        jax = {}
        for s in sizes:
            for prog_name in worker.PROGRAMS:
                # the fused step serves BSP and GAS alike: one JAX run
                jax["fused", prog_name, s] = worker._run_record(
                    _jax_run(prog_name, "bsp", "pallas", s))
        for (p, m, s), f in host.items():
            jax["host", p, m, s] = f.result(timeout=WORLD_TIMEOUT_S)
        ranks = {name: f.result() for name, f in futures.items()}
        ranks["example"] = example.result()
        ranks["failing"] = failing.exception()
        ranks["hanging"] = hanging.exception()
    return ranks, jax


def _assert_state(prog_name, got, want):
    if prog_name in worker.SUM_PROGRAMS:
        np.testing.assert_allclose(got, np.asarray(want), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def _assert_same(prog_name, got: dict, want: dict, keys):
    """A rank's run against another run of the same case."""
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"]
    assert got["stats"] == want["stats"]
    _assert_state(prog_name, got["state"], want["state"])
    for key in keys:
        assert [r.get(key) for r in got["records"]] == \
            [r.get(key) for r in want["records"]], key


def _rank_runs(ranks, key):
    """Every rank's run of ``key``, after checking they are replicated:
    bit-identical states, equal iterations, records and stats."""
    runs = [r["ranks"][key] for r in ranks]
    for r in runs[1:]:
        assert r["state"].tobytes() == runs[0]["state"].tobytes()
        assert (r["iterations"], r["stats"], r["records"]) == \
            (runs[0]["iterations"], runs[0]["stats"], runs[0]["records"])
    return runs[0]


def _single(ranks, key):
    return next(r["single"][key] for r in ranks if key in r["single"])


def test_children_import_nothing_of_jax(worlds):
    ranks, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            assert r["imports"] == [], (name, r["rank"], r["imports"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_ranks_own_contiguous_shards(worlds, world):
    ranks, _ = worlds
    w, local, s = WORLDS[world]
    assert [r["shards"] for r in ranks[world]] == \
        [list(range(i * s // w, (i + 1) * s // w)) for i in range(w)]
    assert all(r["m"] == w * local for r in ranks[world])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("model", worker.MODELS)
@pytest.mark.parametrize("prog_name", worker.PROGRAMS)
def test_fused_loop_across_ranks(worlds, prog_name, model, world):
    ranks, jax = worlds
    w, local, s = WORLDS[world]
    key = ("fused", prog_name, model)
    got = _rank_runs(ranks[world], key)
    assert got["m"] == w * local
    assert all(len(r["shard_blocks_run"]) == s for r in got["records"])
    assert got["stats"]["rounds_total"] == got["iterations"]
    _assert_same(prog_name, got, _single(ranks[world], key), FUSED_KEYS)
    _assert_same(prog_name, got, jax["fused", prog_name, s], FUSED_KEYS)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("model", worker.MODELS)
@pytest.mark.parametrize("prog_name", worker.PROGRAMS)
def test_host_loop_across_ranks(worlds, prog_name, model, world):
    ranks, jax = worlds
    w, local, s = WORLDS[world]
    key = ("host", prog_name, model)
    got = _rank_runs(ranks[world], key)
    single = _single(ranks[world], key)
    _assert_same(prog_name, got, single, HOST_KEYS)
    assert got["wire_stats"] == single["wire_stats"]
    want, jax_m, jax_wire = jax["host", prog_name, model, s]
    _assert_same(prog_name, got, want, HOST_KEYS)
    # what the JAX package counts at the same m
    assert got["wire_stats"] == {
        k: v // jax_m * got["m"] for k, v in jax_wire.items()}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("bits", worker.WIRE_BITS)
def test_compressed_host_loop_equals_one_process(worlds, bits, world):
    ranks, _ = worlds
    key = ("host", "pagerank", "bsp", f"compressed{bits}")
    got = _rank_runs(ranks[world], key)
    want = _single(ranks[world], key)
    assert got["state"].tobytes() == want["state"].tobytes()
    assert (got["iterations"], got["stats"], got["records"],
            got["wire_stats"]) == (want["iterations"], want["stats"],
                                   want["records"], want["wire_stats"])
    assert got["wire_stats"]["compressed_bytes"] > 0


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("fmt", worker.WIRE_FORMATS)
@pytest.mark.parametrize("bits", worker.WIRE_BITS)
def test_rank_wire_equals_the_stacked_wire_and_its_oracle(worlds, bits, fmt,
                                                          world):
    """Two error-feedback rounds: each rank's means and residuals equal
    its rows of the single-process stacked wire at m, bit for bit; the
    first round's mean equals the host oracle (int) or
    ``compressed_allreduce_ref`` (emulated)."""
    ranks, _ = worlds
    w, local, _ = WORLDS[world]
    m = w * local
    width = worker.WIRE_WIDTH
    run = C.make_compressed_allreduce(m, bits=bits, wire=fmt)
    rng = np.random.default_rng(100 + bits)
    res0 = rng.standard_normal((m, width)).astype(np.float32) * 0.01
    res = torch.from_numpy(res0.reshape(-1))
    xs = []
    want = []
    for _ in range(2):
        x = rng.standard_normal((m, width)).astype(np.float32)
        xs.append(x)
        means, res = run(torch.from_numpy(x.reshape(-1)), res)
        want.append((means.numpy().reshape(m, width),
                     res.numpy().reshape(m, width)))
    for r in ranks[world]:
        rows = slice(r["rank"] * local, (r["rank"] + 1) * local)
        for (got_m, got_r), (want_m, want_r) in zip(r["wire"][bits, fmt],
                                                    want):
            np.testing.assert_array_equal(got_m.reshape(local, width),
                                          want_m[rows])
            np.testing.assert_array_equal(got_r.reshape(local, width),
                                          want_r[rows])
    t = xs[0] + res0
    if fmt == "int8":
        oracle = _host_int8_wire([t[j] for j in range(m)], bits)
    else:
        oracle = C.compressed_allreduce_ref(
            [torch.from_numpy(xs[0][j]) for j in range(m)],
            [torch.from_numpy(res0[j]) for j in range(m)], bits=bits)[0][0]
        oracle = oracle.numpy()
    for j in range(m):
        np.testing.assert_array_equal(want[0][0][j], oracle)


# the async loop, structure epochs, out of core and serving across ranks
# run (tests/test_torch_ranks_async.py, tests/test_torch_ranks_epoch.py,
# tests/test_torch_ranks_oocore.py, tests/test_torch_ranks_serve.py); a bad
# monitor or mutation schedule, and migrate() without a monitor, fail as on
# one process (test_bad_epoch_wiring_fails_as_on_one_process).  The MoE
# under a RankMesh (no "model" axis) takes the local path, as in the JAX
# package: None, it runs and equals the one-process result bit for bit
# (the expert layout runs over a RankGrid: tests/test_torch_ranks_moe.py)
REFUSALS = {
    "bad_monitor": (AttributeError, "num_hosts"),
    "bad_mutations": (AttributeError, "due_at"),
    "migrate_without_monitor": (ValueError, "monitor"),
    "moe": None,
    "shards_not_divisible": (ValueError, "must divide"),
    "host_upper": (ValueError, "MeshUpperSystem"),
    "int_daemon_mesh": (ValueError, "is not the upper"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_rank_mesh_refusals(worlds, case):
    ranks, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            got = r["refusals"][case]
            if REFUSALS[case] is None:
                assert got is None, (name, r["rank"], case, got)
                continue
            error, match = REFUSALS[case]
            assert got is not None, (name, r["rank"], case)
            assert got[0] == error.__name__ and match in got[1], got


def _one_process_error(case, shards=4):
    """The exception of a refusal case on one process at ``mesh=shards``,
    as ``(type name, message)``."""
    g = _graph("sssp_bf")[1]

    def mw(**kw):
        return tplug.Middleware(
            g, talg.sssp_bf(g), daemon=tplug.ShardedDaemon(
                kernel="cuda", mesh=shards, csr_config=worker.CSRConfig()),
            upper=tplug.MeshUpperSystem(mesh=shards), num_shards=shards,
            options=tplug.PlugOptions(block_size=worker.BLOCK),
            device="cpu", **kw)

    calls = {"bad_monitor": lambda: mw(monitor=object()),
             "bad_mutations": lambda: mw(mutations=object()).run(),
             "migrate_without_monitor": lambda: mw().migrate()}
    try:
        calls[case]()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["bad_monitor", "bad_mutations",
                                  "migrate_without_monitor"])
def test_bad_epoch_wiring_fails_as_on_one_process(worlds, case):
    ranks, _ = worlds
    want = _one_process_error(case)
    assert want is not None
    for name in WORLDS:
        for r in ranks[name]:
            assert r["refusals"][case] == want, (name, r["rank"])


def test_graph_analytics_example_across_ranks(worlds):
    """``examples.graph_analytics`` under two ranks: one shard a rank, the
    host loop over the RankMesh, each algorithm right on every rank."""
    ranks, _ = worlds
    outs = ranks["example"]
    assert all(out["correct"] == {"sssp_bf": True, "label_prop": True,
                                  "wcc": True} for out in outs)
    np.testing.assert_array_equal(outs[0]["rebalance_fractions"],
                                  outs[1]["rebalance_fractions"])


def test_a_failing_rank_fails_the_caller(worlds):
    """The rank that raised is the one reported, with its traceback."""
    error = worlds[0]["failing"]
    assert isinstance(error, RuntimeError)
    assert re.search("rank 1 of 2 failed(.|\n)*rank 1 gives up", str(error))


def test_a_hung_rank_times_out(worlds):
    error = worlds[0]["hanging"]
    assert isinstance(error, TimeoutError) and "not done within" in str(error)


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo world in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_rank_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        RankMesh(device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_rank_mesh()


@pytest.mark.parametrize("local", [1, 2])
@pytest.mark.parametrize("loop", ["fused", "host"])
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_one_rank_equals_one_process(world_of_one, prog_name, loop, local):
    """A world of one rank and ``local`` devices runs the one-process
    loop at m = local, bit for bit (an all_reduce of one rank is the
    identity)."""
    rm = RankMesh(local=local, device="cpu")
    assert (rm.world, rm.rank, rm.size, rm.backend) == (1, 0, local, "gloo")
    graph = _graph(prog_name)[1]
    got = worker.middleware(graph, prog_name, loop, "bsp", 4, rm, "cpu")
    want = worker.middleware(graph, prog_name, loop, "bsp", 4, local, "cpu")
    assert got.device == torch.device("cpu") and got.upper.m == local
    a = worker._run_record(got.run(max_iterations=worker.max_it(prog_name)),
                           got.upper)
    b = worker._run_record(want.run(max_iterations=worker.max_it(prog_name)),
                           want.upper)
    assert a["state"].tobytes() == b["state"].tobytes()
    assert {k: v for k, v in a.items() if k != "state"} == \
        {k: v for k, v in b.items() if k != "state"}


def test_rank_mesh_axis_and_bad_meshes(world_of_one):
    rm = RankMesh(local=2, device="cpu")
    assert rm.size == 2 and rm.cpu_group is rm.group
    assert divisor_mesh(4, rm) == 2 and shard_range(8, rm) == range(8)
    assert shard_range(4) == range(4)
    for bad in (3, 5):
        with pytest.raises(ValueError, match="must divide"):
            divisor_mesh(bad, rm)
    for local in (0, -1, True, 1.5):
        with pytest.raises(ValueError, match="local"):
            RankMesh(local=local, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            RankMesh()  # the card is the default
        g = _graph("sssp_bf")[1]
        with pytest.raises(RuntimeError, match="cuda"):
            tplug.Middleware(g, talg.sssp_bf(g), upper=tplug.MeshUpperSystem(
                mesh=rm), device="cuda")
    assert rm.all_reduce_host(np.array([3, 1]), "max").tolist() == [3, 1]
    with pytest.raises(ValueError, match="op"):
        rm.all_reduce(torch.zeros(1), "prod")
