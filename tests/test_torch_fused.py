"""The port's device-resident fused loop (``daemon="sharded"`` +
``upper="mesh"`` + ``DriveLoop``) against the JAX package's own fused loop
of the same composition, on the CPU.

Matrix: programs × models {bsp, gas} × kernels × num_shards {1, 4}.  The
port's ``kernel="cuda"`` runs the CSR-tile kernel's plain version here, its
config pinned to ``CSRConfig()``; its JAX counterpart is
``kernel="pallas"`` at the counterpart config (:func:`jax_config`), with
the Pallas CSR tile in interpret mode, so that both cut the same tiles and
count the same ``blocks_run``.  ``kernel="reference"`` is the block program
on both sides.

* min programs (sssp_bf, wcc, bfs) run to convergence and must match bit
  for bit; sum programs (pagerank, label_prop) run ``MAX_IT`` iterations
  and match within rtol=1e-5, atol=1e-6 (float32 sums in another order);
* iterations, the converged flag, ``SyncStats`` and every per-iteration
  record's ``blocks_total`` / ``blocks_run`` / ``shard_blocks_run`` /
  ``active`` must be equal.

The JAX mesh axis spans as many CPU devices as the process has (the JAX
package's ``divisor_mesh``); the port's spans one logical device here
(``mesh=None``; tests/test_torch_mesh.py takes m > 1).  No assertion
depends on the JAX side's count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import plug as jplug
from repro.graph import algorithms as jalg
from repro.graph import compaction as jcompaction
from repro.graph import generate as jgenerate
from repro.kernels.autotune import CSRConfig as JCSRConfig
from repro_torch import convert
from repro_torch import plug as tplug
from repro_torch.graph import algorithms as talg
from repro_torch.graph import compaction as tcompaction
from repro_torch.graph import generate as tgenerate
from repro_torch.kernels.ops import CSRConfig

MAX_IT = 12
BLOCK = 64  # several blocks a shard, so frontier skipping has work to skip
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ["pagerank", "sssp_bf", "wcc", "bfs", "label_prop"]
KERNELS = {"reference": "reference", "cuda": "pallas"}  # port → JAX
LOWERINGS = {"cuda": "pallas", "torch": "xla"}  # port → JAX
RECORD_KEYS = ("blocks_total", "blocks_run", "shard_blocks_run", "active")

_graphs: dict = {}
_jax_runs: dict = {}


def _graph(prog_name):
    """(JAX graph, port graph) — the port's carried across as arrays."""
    key = "wcc" if prog_name == "wcc" else "directed"
    if key not in _graphs:
        gj = jgenerate.rmat(256, 2048, seed=9)
        if key == "wcc":
            gj = gj.with_reverse_edges()
        _graphs[key] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[key]


def _max_it(prog_name):
    return MAX_IT if prog_name in ("pagerank", "label_prop") else None


def jax_config(cfg: CSRConfig) -> JCSRConfig:
    """The JAX package's counterpart of a port config, field for field:
    lowering ``cuda`` ↔ ``pallas`` and ``torch`` ↔ ``xla``; merge, gather,
    edge tile and hub threshold by the same names."""
    return JCSRConfig(edge_tile=cfg.edge_tile,
                      lowering=LOWERINGS[cfg.lowering], merge=cfg.merge,
                      gather=cfg.gather, hub_threshold=cfg.hub_threshold)


def _jax_daemon(kernel):
    if kernel == "reference":
        return jplug.get_daemon("sharded", kernel="reference")
    return jplug.get_daemon("sharded", kernel="pallas",
                            csr_config=jax_config(CSRConfig()))


def _jax_run(prog_name, model, kernel, shards, upper="mesh"):
    key = (prog_name, model, kernel, shards, upper)
    if key not in _jax_runs:
        gj, _ = _graph(prog_name)
        mw = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                              daemon=_jax_daemon(kernel), upper=upper,
                              model=model, num_shards=shards,
                              options=jplug.PlugOptions(block_size=BLOCK))
        assert mw._fused_kind == ("bsp" if upper == "mesh" else None)
        _jax_runs[key] = mw.run(max_iterations=_max_it(prog_name))
    return _jax_runs[key]


def _port(prog_name, kernel="reference", shards=4, upper="mesh", **kw):
    _, gt = _graph(prog_name)
    return tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt),
        daemon=tplug.get_daemon("sharded", kernel=kernel,
                                csr_config=CSRConfig()), upper=upper,
        num_shards=shards, options=tplug.PlugOptions(block_size=BLOCK),
        device="cpu", **kw)


def _assert_same_run(prog_name, res, want):
    assert res.iterations == want.iterations
    assert res.converged == want.converged
    assert res.stats.as_dict() == want.stats.as_dict()
    if prog_name in ("pagerank", "label_prop"):
        np.testing.assert_allclose(res.state, np.asarray(want.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(res.state, np.asarray(want.state))


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("model", ["bsp", "gas"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_fused_loop_matches_jax_fused_loop(prog_name, model, kernel, shards):
    mw = _port(prog_name, kernel, shards, model=model)
    assert mw._fused_kind == "bsp"
    res = mw.run(max_iterations=_max_it(prog_name))
    assert isinstance(mw._loop, tplug.DriveLoop)
    want = _jax_run(prog_name, model, KERNELS[kernel], shards)
    assert all(r["fused"] for r in res.per_iteration)
    assert all(r.get("fused") for r in want.per_iteration)
    _assert_same_run(prog_name, res, want)
    for key in RECORD_KEYS:
        assert [r[key] for r in res.per_iteration] == \
            [r[key] for r in want.per_iteration], key
    assert all(len(r["shard_blocks_run"]) == shards
               for r in res.per_iteration)
    assert res.stats.rounds_total == res.iterations


def test_partitions_and_blocks_match_jax():
    """Both packages partition and block the graph alike, so the stacked
    layouts line up shard for shard."""
    gj, gt = _graph("sssp_bf")
    mj = jplug.Middleware(gj, jalg.sssp_bf(gj), daemon="sharded",
                          upper="mesh", num_shards=4,
                          options=jplug.PlugOptions(block_size=BLOCK))
    mt = _port("sssp_bf")
    assert [p.num_edges for p in mj.partitions] == \
        [p.num_edges for p in mt.partitions]
    for name, got in mt.daemon.stacked.items():
        if name != "csr":
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(mj.daemon.stacked[name]))


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_run_all_shards_folds_to_the_per_shard_aggregates(prog_name, kernel):
    """run_all_shards' (m, N, K) partials fold over the shard axis to the
    fold of the classic per-shard run_blocks aggregates — bit-equal for
    the min monoid — and merge_partials gives the same fold."""
    mw = _port(prog_name, kernel)
    prog = mw.program
    state, aux = prog.init(mw.graph)
    st, ax = torch.from_numpy(state), torch.from_numpy(aux)
    partials, counts, blocks_run = mw.daemon.run_all_shards(st, ax)
    n, k = mw.n, prog.state_width
    m = mw.daemon.m
    assert partials.shape == (m, n, k) and counts.shape == (m, n)
    assert counts.dtype == torch.int32 and blocks_run.shape == (4,)
    aggs, cnts = zip(*(mw.daemon.run_blocks(state, aux, bs,
                                            np.arange(bs.num_blocks), {})
                       for bs in mw.blocksets))
    if prog.monoid.idempotent:
        want = np.minimum.reduce(aggs)
    else:
        want = np.add.reduce(aggs)
    want_cnt = np.add.reduce([c.astype(np.int64) for c in cnts])
    agg, cnt = mw.upper.merge_partials(partials, counts)
    for got in (mw.upper._fold_axis(partials), agg):
        if prog.monoid.idempotent:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    assert cnt.dtype == torch.int32


def test_run_all_shards_frontier_skips_blocks_and_tiles():
    """With a frontier, blocks (tiles for the CSR body) with no active
    source are skipped and counted out of blocks_run; with no active
    vertex nothing runs and the partials are the identity."""
    for kernel in ("reference", "cuda"):
        mw = _port("bfs", kernel)
        state, aux = (torch.from_numpy(a) for a in mw.program.init(mw.graph))
        _, _, every = mw.daemon.run_all_shards(state, aux)
        few = torch.zeros(mw.n, dtype=torch.bool)
        few[0] = True
        _, _, some = mw.daemon.run_all_shards(state, aux, few)
        assert int(some.sum()) < int(every.sum())
        p, c, none = mw.daemon.run_all_shards(
            state, aux, torch.zeros(mw.n, dtype=torch.bool))
        assert int(none.sum()) == 0 and int(c.sum()) == 0
        assert bool((p == mw.program.monoid.identity).all())


@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_mesh_merge_matches_jax_mesh_merge(prog_name):
    """The classic path's merge of per-shard host arrays, against the JAX
    package's MeshUpperSystem.merge on the same arrays."""
    gj, gt = _graph(prog_name)
    pj, pt = jalg.ALGORITHMS[prog_name](gj), talg.ALGORITHMS[prog_name](gt)
    uj = jplug.MeshUpperSystem().bind(pj, 4)
    ut = tplug.MeshUpperSystem().bind(pt, 4)
    rng = np.random.default_rng(0)
    shape = (gt.num_vertices, pt.state_width)
    states = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)]
    aggs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    cnts = [rng.integers(0, 3, gt.num_vertices).astype(np.int32)
            for _ in range(4)]
    got = ut.merge(states, aggs, cnts)
    want = uj.merge(states, aggs, cnts)
    for g, w in zip(got, want):
        if pt.monoid.idempotent:
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
    assert ut.m == 1 and ut.mesh == 1
    assert ut.wire_stats["exact_bytes"] == 4 * np.prod(shape) * ut.m
    ut.reset()
    assert ut.wire_stats == {"exact_bytes": 0, "compressed_bytes": 0}


@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_mesh_upper_runs_the_host_loop_with_a_per_shard_daemon(prog_name):
    """daemon="cuda" (no run_all_shards) with upper="mesh" keeps the host
    loop and merges through MeshUpperSystem.merge, as the JAX package's
    per-shard daemon with its mesh upper does."""
    gj, gt = _graph(prog_name)
    mt = tplug.Middleware(gt, talg.ALGORITHMS[prog_name](gt),
                          daemon=tplug.VectorizedDaemon(
                              kernel="cuda", csr_config=CSRConfig()),
                          upper="mesh", num_shards=4,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert mt._fused_kind is None
    res = mt.run(max_iterations=_max_it(prog_name))
    assert isinstance(mt._loop, tplug.HostDriveLoop)
    assert mt.upper.wire_stats["exact_bytes"] > 0
    mj = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                          daemon="reference", upper="mesh", num_shards=4,
                          options=jplug.PlugOptions(block_size=BLOCK))
    want = mj.run(max_iterations=_max_it(prog_name))
    _assert_same_run(prog_name, res, want)
    assert not any(r.get("fused") for r in res.per_iteration)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_sharded_daemon_with_host_upper_runs_the_host_loop(kernel):
    """daemon="sharded" with upper="host" runs the classic per-shard path
    (run_blocks inherited from VectorizedDaemon) and matches the JAX
    package's same composition."""
    mw = _port("sssp_bf", kernel, shards=2, upper="host")
    assert mw._fused_kind is None and mw.daemon.stacked is None
    res = mw.run()
    want = _jax_run("sssp_bf", "bsp", KERNELS[kernel], 2, upper="host")
    _assert_same_run("sssp_bf", res, want)
    assert not any(r.get("fused") for r in res.per_iteration)
    assert [r["blocks_run"] for r in res.per_iteration] == \
        [r["blocks_run"] for r in want.per_iteration]


def _hooked_models(pkg):
    """A BSP subclass with a custom hook and a model of another order: the
    fused step would bypass both."""

    class DeltaBSP(pkg.BSP):
        name = "delta-bsp"

        def aggregates(self, gather, pending, record):
            record["delta"] = True
            return gather(record)

    class Priority(pkg.BSP):
        name = "priority"
        order = ("apply", "gen", "merge")

    return DeltaBSP(), Priority()


def test_models_the_fused_step_would_bypass_keep_the_host_loop():
    gj, gt = _graph("sssp_bf")
    delta_t, prio_t = _hooked_models(tplug)
    delta_j, _ = _hooked_models(jplug)
    assert _port("sssp_bf", model=prio_t)._fused_kind is None
    mw = _port("sssp_bf", model=delta_t)
    assert mw._fused_kind is None
    res = mw.run()
    assert all(r.get("delta") for r in res.per_iteration)
    mj = jplug.Middleware(gj, jalg.sssp_bf(gj), daemon="sharded",
                          upper="mesh", model=delta_j, num_shards=4,
                          options=jplug.PlugOptions(block_size=BLOCK))
    assert not mj._fused
    _assert_same_run("sssp_bf", res, mj.run())
    # a subclass that keeps the hooks still fuses
    assert _port("sssp_bf", model=type("MyGAS", (tplug.GAS,), {})()
                 )._fused_kind == "bsp"


_TRANSFERS = ("cpu", "tolist", "item", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_fused_state_never_reaches_the_host_inside_the_loop(kernel,
                                                            monkeypatch):
    """Inside the fused loop no vertex-sized tensor reaches the host, and
    exactly one small fetch is made an iteration: every way a tensor
    reaches the host (``cpu``/``to`` a CPU device, ``tolist``, ``item``,
    ``bool``/``int``/``float``) is counted, by size, over a 3- and a
    10-iteration run; the final state crosses once."""
    mw = _port("pagerank", kernel)
    n = mw.n
    mw.run(max_iterations=2)
    calls = []

    def counting(name, orig):
        def wrapper(self, *args, **kwargs):
            calls.append((name, self.numel()))
            return orig(self, *args, **kwargs)
        return wrapper

    for name in _TRANSFERS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    orig_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        target = kwargs.get("device", args[0] if args else None)
        if isinstance(target, (str, torch.device)) and \
                torch.device(target).type == "cpu":
            calls.append(("to", self.numel()))
        return orig_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", to)

    def counted(iters):
        calls.clear()
        res = mw.run(max_iterations=iters)
        assert res.iterations == iters
        big = [c for c in calls if c[1] >= n]
        small = [c for c in calls if c[1] < n]
        return big, small

    big3, small3 = counted(3)
    big10, small10 = counted(10)
    assert big3 == big10 == [("cpu", n * mw.k)]
    assert [c[0] for c in small3] == ["tolist"] * 3
    assert [c[0] for c in small10] == ["tolist"] * 10


def test_repeated_runs_and_run_overrides():
    mw = _port("sssp_bf", "cuda")
    prog = mw.program
    a, b = mw.run(), mw.run()
    np.testing.assert_array_equal(a.state, b.state)
    assert a.stats.as_dict() == b.stats.as_dict()
    assert a.per_iteration == b.per_iteration
    # init= override: a source already at 0 elsewhere changes the answer
    state0, aux = prog.init(mw.graph)
    moved = state0.copy()
    moved[5] = 0.0
    c = mw.run(init=lambda g: (moved, aux))
    ref, _ = tplug.run_reference(mw.graph, dataclasses.replace(
        prog, init=lambda g: (moved, aux)), device="cpu")
    np.testing.assert_array_equal(c.state, ref)
    assert not np.array_equal(c.state, a.state)
    # nothing active: no messages, the state stays
    quiet = mw.run(frontier=np.zeros(mw.n, bool))
    np.testing.assert_array_equal(quiet.state, state0)
    assert quiet.converged and quiet.iterations == 1
    assert quiet.per_iteration[0]["blocks_run"] == 0
    with pytest.raises(ValueError, match="frontier"):
        mw.run(frontier=np.ones(mw.n + 1, bool))


def test_pad_tileset_matches_jax():
    gj, gt = _graph("sssp_bf")
    mj = jplug.Middleware(gj, jalg.sssp_bf(gj), num_shards=2,
                          options=jplug.PlugOptions(block_size=BLOCK))
    mt = _port("sssp_bf", shards=2, upper="host")
    tj = jcompaction.tiles_from_blockset(mj.blocksets[0], gj.num_vertices)
    tt = tcompaction.tiles_from_blockset(mt.blocksets[0], gt.num_vertices)
    env = dict(num_tiles=tt.num_tiles + 3, row_tile=tt.row_tile + 8,
               src_tile=tt.src_tile + 16)
    pj = jcompaction.pad_tileset(tj, **env)
    pt = tcompaction.pad_tileset(tt, **env)
    for f in ("rows", "seg", "lsrc", "svids", "w", "emask", "gsrc", "gdst",
              "eblock"):
        got, want = getattr(pt, f), getattr(pj, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (pt.num_tiles, pt.row_tile, pt.src_tile) == \
        (pj.num_tiles, pj.row_tile, pj.src_tile)
    assert (pt.eblock[tt.num_tiles:] == -1).all()
    assert not pt.emask[tt.num_tiles:].any()
    with pytest.raises(ValueError, match="smaller"):
        tcompaction.pad_tileset(tt, num_tiles=tt.num_tiles - 1,
                                row_tile=tt.row_tile, src_tile=tt.src_tile)


def test_share_from_adopts_the_donors_stacked_tensors():
    """A second middleware on the same graph adopts every stacked field of
    its donor; one on another graph adopts none."""
    donor = _port("sssp_bf", "cuda")
    fields = {**{k: v for k, v in donor.daemon.stacked.items()
                 if k != "csr"},
              **{"csr/" + k: v
                 for k, v in donor.daemon.stacked["csr"].items()}}
    _, gt = _graph("bfs")
    twin = tplug.Middleware(
        gt, talg.bfs(gt), upper="mesh", num_shards=4,
        daemon=tplug.ShardedDaemon(kernel="cuda", csr_config=CSRConfig()
                                   ).share_from(donor.daemon),
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    assert twin.daemon.adopted_fields == len(fields) == 13
    assert twin.daemon.stacked["csr"]["svids"] is \
        donor.daemon.stacked["csr"]["svids"]
    np.testing.assert_array_equal(twin.run().state, tplug.run_reference(
        gt, talg.bfs(gt), device="cpu")[0])
    other = tgenerate.rmat(256, 2048, seed=10)
    stranger = tplug.Middleware(
        other, talg.sssp_bf(other), upper="mesh", num_shards=4,
        daemon=tplug.ShardedDaemon(kernel="cuda", csr_config=CSRConfig()
                                   ).share_from(donor.daemon),
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    assert stranger.daemon.adopted_fields == 0
    # a re-bind of the same blocksets reuses their compacted tiles
    d = donor.daemon
    recut = d.tiles_recut
    d.bind_shards(donor.blocksets)
    assert d.tiles_recut == recut and d.tilesets_reused == 4


def test_not_ported_parts_raise_naming_their_item():
    _, gt = _graph("sssp_bf")
    # an int m is m logical devices on one card; a device mesh across
    # cards or ranks is item 13c's
    with pytest.raises(NotImplementedError, match="item 13"):
        _port("sssp_bf", upper=tplug.MeshUpperSystem(mesh=("shard", 2)))
    daemon = tplug.ShardedDaemon(mesh=("shard", 4)).bind(
        talg.sssp_bf(gt), gt.num_vertices, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        daemon.bind_shards(_port("sssp_bf").blocksets)
    # item 13b is ported on one card: the compressed wire refuses a min
    # program, as the JAX package's does
    with pytest.raises(ValueError, match="idempotent"):
        _port("sssp_bf", upper=tplug.MeshUpperSystem(wire="compressed"))
    # item 8 is ported: the async model on sharded + mesh is the fused
    # async loop
    assert _port("sssp_bf", model="async")._fused_kind == "async"
    with pytest.raises(ValueError, match="wire"):
        tplug.MeshUpperSystem(wire="int3")
    with pytest.raises(RuntimeError, match="bind_shards"):
        tplug.ShardedDaemon().run_all_shards(None, None)
