"""Graph-query serving across ``torch.distributed`` ranks on the CPU:
``GraphServeSession(mesh=RankMesh)`` over W gloo ranks, every rank running
the same router on the same seeded workload, against the port's
one-process session at ``mesh=m`` and the JAX package's session.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous in a temporary directory): 4 ranks × 1 logical
device and 2 × 2 over 4 shards, 4 × 2 over 8.  Every rank runs
``torch_ranks_worker.serve_script`` (tests/torch_ranks_worker.py) with
``kernel="cuda"`` (the CSR tile's plain twin at ``CSRConfig()``); rank 0
also runs it at ``mesh=m``; JAX's session (``kernel="pallas"`` at the
counterpart config, the Pallas tile in interpret mode) runs the same
script meanwhile, in two processes:

* a batch of each kind (khop, sssp, ppr) — khop and sssp bit-equal, ppr
  within rtol 1e-5 / atol 1e-6 — with JAX's records, and both lookup
  fields (pagerank within the same tolerance, wcc exact);
* a seeded replay through ``GraphServeRouter``: the batches (kind, params,
  seeds) the same on every rank and the one-process router's and JAX's,
  every answer the same on every rank;
* a mutation batch through ``GraphServeRouter.mutate``: the record JAX's,
  the answers after it;
* a kill (device 1 before iteration 5) and its join (before 8) inside one
  PPR run: two migrations, the same volatile flush on every rank, the
  durable khop answer kept, and the answers after the join exact.

Every rank's answers are bit-identical to rank 0's, idle ranks' included.
"""
import concurrent.futures
import multiprocessing
import os

# before JAX starts its backend: serving wants a multi-device host mesh
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_ranks_worker as worker  # noqa: E402
from repro import plug as jplug  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.dist import fault as jfault  # noqa: E402
from repro.graph import mutation as jmutation  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from test_torch_fused import SUM_ATOL, SUM_RTOL, _graph  # noqa: E402
from test_torch_serve import _JaxSession  # noqa: E402

WORLDS = {"4x1": (4, 1, 4), "2x2": (2, 2, 4), "4x2": (4, 2, 8)}
WORLD_TIMEOUT_S = 150.0
# launch.graph_serve under two ranks: device 1 (rank 1's) dies before
# iteration 2 and is back before 4
LAUNCHER_ARGV = ["--device", "cpu", "--num-vertices", "300",
                 "--num-edges", "2400", "--requests", "24", "--rate", "400",
                 "--num-shards", "4", "--kill-at", "2", "--kill-device", "1",
                 "--recover-at", "4"]
# answers of these kinds are sums: held within tolerance across a merge
# order change
SUMS = ("ppr", "lookup")


def _jax_script(shards):
    """The serving script on JAX's session over ``shards`` shards (JAX's m
    is ``shards`` here) → its outputs and JAX's m."""
    gj = _graph("sssp_bf")[0]

    def make_session(**extra):
        return _JaxSession(gj, num_shards=shards, kernel="pallas",
                           max_batch=8, block_size=worker.BLOCK, **extra)

    def make_log(edges):
        log = jmutation.MutationLog()
        for u, v, w in edges:
            log.add_edge(u, v, w)
        return log

    def failures():
        return (jfault.FleetMonitor(num_hosts=shards),
                jplug.FailureSchedule(**worker.SERVE_KILL))

    out = worker.serve_script(jserve, make_session, make_log, failures)
    m = make_session()._family("sssp", (), 1)["mw"].daemon.m
    return out, m


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank outputs and JAX's by shard count."""
    tmp = tmp_path_factory.mktemp("ranks_serve")
    graph = _graph("sssp_bf")[1]
    spawn = multiprocessing.get_context("spawn")
    sizes = sorted({s for _, _, s in WORLDS.values()})
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 1) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                len(sizes), mp_context=spawn) as procs:
        futures = {
            name: threads.submit(spawn_ranks, worker.serve_world, w,
                                 (graph, s, local), backend="gloo",
                                 init_method=f"file://{tmp}/{name}",
                                 timeout_s=WORLD_TIMEOUT_S)
            for name, (w, local, s) in WORLDS.items()}
        launcher = threads.submit(spawn_ranks, worker.graph_serve_world, 2,
                                  (LAUNCHER_ARGV,), backend="gloo",
                                  init_method=f"file://{tmp}/launcher",
                                  timeout_s=WORLD_TIMEOUT_S)
        jax = {s: procs.submit(_jax_script, s) for s in sizes}
        jax = {s: f.result(timeout=WORLD_TIMEOUT_S) for s, f in jax.items()}
        ranks = {name: f.result() for name, f in futures.items()}
        ranks["launcher"] = launcher.result()
    return ranks, jax


def _same(kind, got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    if kind in SUMS and not exact:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _assert_outputs(got, want, exact=False):
    """Two scripts' outputs the same: min answers bit for bit, sums within
    tolerance (bit for bit with ``exact``), records and batches equal."""
    for kind, (answers, rec) in want["batches"].items():
        g_answers, g_rec = got["batches"][kind]
        assert g_rec == rec, kind
        for a, b in zip(g_answers, answers, strict=True):
            _same(kind, a, b, exact)
    for field, answers in want["lookups"].items():
        for a, b in zip(got["lookups"][field], answers, strict=True):
            _same("lookup" if field == "pagerank" else "wcc", a, b, exact)
    rg, rw = got["replay"], want["replay"]
    assert rg["calls"] == rw["calls"]
    assert (rg["completed"], rg["cached"]) == (rw["completed"], rw["cached"])
    for a, b in zip(rg["answers"], rw["answers"], strict=True):
        assert a[:4] == b[:4]
        _same(a[0][0], a[4], b[4], exact)
    assert got["mutate"]["record"] == want["mutate"]["record"]
    for a, b in zip(got["mutate"]["after"], want["mutate"]["after"],
                    strict=True):
        assert a[:2] == b[:2]
        _same(a[0], a[2], b[2], exact)
    kg, kw = got["kill"], want["kill"]
    for key in ("epoch", "sentinel", "flushed", "khop_kept", "hit",
                "after_epoch", "after_migrations"):
        assert kg[key] == kw[key], key
    _same("khop", kg["warm"], kw["warm"])
    _same("ppr", kg["ppr"], kw["ppr"], exact)
    for a, b in zip(kg["sssp"], kw["sssp"], strict=True):
        _same("sssp", a, b)


def test_children_import_nothing_of_jax(worlds):
    ranks, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            assert r["imports"] == [], (name, r["rank"], r["imports"])


def test_launcher_under_two_ranks(worlds):
    """``launch.graph_serve`` with ``WORLD_SIZE`` set serves over a
    RankMesh of the two ranks, through a kill of rank 1's device and its
    join: every rank completes the replay with the same answers, those of
    the launcher on one process at ``--mesh 2``."""
    from repro_torch.launch import graph_serve

    ranks, _ = worlds
    (counts0, got0), (counts1, got1) = ranks["launcher"]
    assert counts0 == counts1 and counts0[0] == 24
    want_counts, want = worker.launcher_answers(
        graph_serve, LAUNCHER_ARGV + ["--mesh", "2"])
    assert counts0 == want_counts
    for a, b, c in zip(got0, got1, want, strict=True):
        assert a[:2] == b[:2] == c[:2]
        np.testing.assert_array_equal(a[2], b[2])
        _same(a[0][0], a[2], c[2])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_rank_answers_the_same(worlds, world):
    """Answers, records, batches, the mutation and the kill are the same on
    every rank, bit for bit (an idle rank takes the leader's)."""
    ranks, _ = worlds
    for r in ranks[world][1:]:
        _assert_outputs(r["ranks"], ranks[world][0]["ranks"], exact=True)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_serving_across_ranks_equals_one_process(worlds, world):
    ranks, _ = worlds
    got, want = ranks[world][0]["ranks"], ranks[world][0]["single"]
    _assert_outputs(got, want)
    assert got["families"] == want["families"]
    assert got["init_keys"] == want["init_keys"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_serving_across_ranks_matches_jax(worlds, world):
    ranks, jax = worlds
    w, local, s = WORLDS[world]
    want, jax_m = jax[s]
    assert jax_m == w * local
    _assert_outputs(ranks[world][0]["ranks"], want)
    assert ranks[world][0]["ranks"]["families"] == want["families"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_batches_against_run_reference(worlds, world):
    """khop and sssp columns bit-equal to each query's solo
    ``run_reference``; the duplicate queries' columns bit-equal."""
    ranks, _ = worlds
    g = _graph("sssp_bf")[1]
    batches = ranks[world][0]["ranks"]["batches"]
    for kind in ("khop", "sssp"):
        answers, rec = batches[kind]
        assert rec["converged"] and rec["bucket"] == 4
        factory = talg.BATCHED_QUERIES[kind]
        kw = dict(worker.SERVE_PARAMS[kind])
        for q, seeds in enumerate(worker.SERVE_SEEDS):
            ref = tplug.run_reference(g, factory(g, [seeds], **kw),
                                      device="cpu")[0]
            np.testing.assert_array_equal(answers[q], np.asarray(ref)[:, 0])
        np.testing.assert_array_equal(answers[1], answers[2])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_kill_and_join_mid_serve(worlds, world):
    """Two migrations inside the PPR run (the kill and the join), the
    volatile sentinel flushed and the durable khop answer kept on every
    rank; the family back at the world's m."""
    ranks, _ = worlds
    w, local, _ = WORLDS[world]
    for r in ranks[world]:
        k = r["ranks"]["kill"]
        assert k["epoch"] == 2 and k["after_epoch"] == 2
        assert not k["sentinel"] and k["flushed"] == 1 and k["khop_kept"]
        assert k["hit"] and k["after_migrations"] == 0
        assert k["ppr_m"] == (local if len(ranks[world]) > 1 else w * local)
