"""The fused async loop across ``torch.distributed`` ranks on the CPU: W gloo
ranks over ``dist.sharding.RankMesh`` under ``AsyncModel`` against the
port's single-process ``mesh=m`` and the JAX package's async fused loop.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous in a temporary directory): 4 ranks × 1 logical
device and 2 × 2 over 4 shards, 4 × 2 over 8 shards.  Every rank runs
sssp_bf, bfs, wcc and pagerank under the three arms of
tests/test_torch_async.py (``eager``, ``holding``, ``buckets``) through
``AsyncDriveLoop`` (tests/torch_ranks_worker.py), and its share of the same
cases at ``mesh=m``.  The JAX oracles (``kernel="pallas"`` at the
counterpart config, the port's CSR tile through its plain twin) run in
three processes meanwhile.

* min programs bit for bit, with equal iterations and every record's
  ``run_mask``, ``refreshed``, ``gen_run``, ``gen_skipped``, ``theta``,
  ``shard_blocks_run`` and ``active`` — against ``mesh=m`` and against
  JAX, whose m (over 8 CPU devices) must equal the world's;
* pagerank within rtol 1e-5 / atol 1e-6 (the all_reduce adds the ranks'
  partials in its own order), ``eager``'s records equal;
* every rank's run bit-identical to rank 0's; a device held by the run
  mask ran no tile, on every rank's records.
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
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from test_torch_async import ARMS, RECORD_KEYS, _holds  # noqa: E402
from test_torch_fused import (SUM_ATOL, SUM_RTOL, _graph,  # noqa: E402
                              _jax_daemon)

WORLDS = {"4x1": (4, 1, 4), "2x2": (2, 2, 4), "4x2": (4, 2, 8)}
WORLD_TIMEOUT_S = 150.0
CASES = [(p, a) for p in worker.ASYNC_PROGRAMS for a in worker.ASYNC_ARMS]


def _jax_async(prog_name, arm, shards):
    """JAX's async fused loop → (the run as ``worker._run_record`` gives it,
    JAX's m)."""
    gj, _ = _graph(prog_name)
    mw = jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon("cuda"),
        upper="mesh", model=jplug.AsyncModel(**ARMS[arm]),
        num_shards=shards, options=jplug.PlugOptions(block_size=worker.BLOCK))
    assert mw._fused_kind == "async"
    res = mw.run(max_iterations=worker.max_it(prog_name))
    return worker._run_record(res), mw.daemon.m


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank results and the JAX oracles by (program,
    arm, shards)."""
    tmp = tmp_path_factory.mktemp("ranks_async")
    graphs = {"directed": _graph("sssp_bf")[1], "wcc": _graph("wcc")[1]}
    sizes = sorted({s for _, _, s in WORLDS.values()})
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                3, mp_context=spawn) as procs:
        futures = {
            name: threads.submit(spawn_ranks, worker.async_world, w,
                                 (graphs, s, local), backend="gloo",
                                 init_method=f"file://{tmp}/{name}",
                                 timeout_s=WORLD_TIMEOUT_S)
            for name, (w, local, s) in WORLDS.items()}
        jax = {(p, a, s): procs.submit(_jax_async, p, a, s)
               for s in sizes for p, a in CASES}
        jax = {k: f.result(timeout=WORLD_TIMEOUT_S) for k, f in jax.items()}
        ranks = {name: f.result() for name, f in futures.items()}
    return ranks, jax


class _AsResult:
    """A run record read as ``_holds`` reads a ``Result``."""

    def __init__(self, run):
        self.per_iteration = run["records"]


def _rank_run(ranks, key):
    """Every rank's run of ``key`` after checking they are replicated:
    bit-identical states, equal iterations, records and stats."""
    runs = [r["ranks"][key] for r in ranks]
    for r in runs[1:]:
        assert r["state"].tobytes() == runs[0]["state"].tobytes()
        assert (r["iterations"], r["converged"], r["stats"], r["records"]) \
            == (runs[0]["iterations"], runs[0]["converged"],
                runs[0]["stats"], runs[0]["records"])
    return runs[0]


def _single(ranks, key):
    return next(r["single"][key] for r in ranks if key in r["single"])


def _assert_records(got, want):
    assert len(got["records"]) == len(want["records"])
    for a, b in zip(got["records"], want["records"]):
        for key in RECORD_KEYS:
            assert a[key] == b[key], (a["iteration"], key, a[key], b[key])


def _assert_same(prog_name, arm, got, want):
    if prog_name in worker.SUM_PROGRAMS:
        np.testing.assert_allclose(got["state"], np.asarray(want["state"]),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
        assert got["iterations"] == want["iterations"]
        if arm == "eager":
            _assert_records(got, want)
        return
    np.testing.assert_array_equal(got["state"], np.asarray(want["state"]))
    assert (got["iterations"], got["converged"]) == \
        (want["iterations"], want["converged"])
    _assert_records(got, want)


def test_arms_are_the_one_process_tests_arms():
    assert worker.ASYNC_ARMS == ARMS


def test_children_import_nothing_of_jax(worlds):
    ranks, _ = worlds
    for name in WORLDS:
        for r in ranks[name]:
            assert r["imports"] == [], (name, r["rank"], r["imports"])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("arm", sorted(worker.ASYNC_ARMS))
@pytest.mark.parametrize("prog_name", worker.ASYNC_PROGRAMS)
def test_async_loop_across_ranks(worlds, prog_name, arm, world):
    ranks, jax = worlds
    w, local, s = WORLDS[world]
    key = (prog_name, arm)
    got = _rank_run(ranks[world], key)
    assert got["m"] == w * local
    assert all(r["async"] and r["devices"] == w * local
               and len(r["run_mask"]) == w * local
               and len(r["shard_blocks_run"]) == s for r in got["records"])
    _holds(_AsResult(got), shards=s)
    if prog_name not in worker.SUM_PROGRAMS:
        assert got["converged"]
    _assert_same(prog_name, arm, got, _single(ranks[world], key))
    want, jax_m = jax[prog_name, arm, s]
    assert jax_m == w * local
    _assert_same(prog_name, arm, got, want)


def test_holding_holds_across_ranks(worlds):
    """The holding arm really holds at m = 8 (at m = 4 this graph gives
    the run mask no reason to): some device held by the mask, which then
    ran no tile — on the ranks as on one process."""
    ranks, _ = worlds
    runs = [(_rank_run(ranks["4x2"], (p, "holding")),
             _single(ranks["4x2"], (p, "holding")))
            for p in worker.ASYNC_PROGRAMS]
    held = [_holds(_AsResult(got), shards=8) for got, _ in runs]
    assert sum(held) > 0
    assert held == [_holds(_AsResult(want), shards=8) for _, want in runs]
