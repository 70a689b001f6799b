"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
without a CUDA device — the kernels have no CPU mode).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  The graph kernels, for every message function × monoid: min/max/or
bit-equal, sum within rtol=1e-5, atol=1e-6 (the kernels add in another order
than the plain version's scatter).  Flash attention: atol 2e-5 in float32;
in bfloat16 |Δ| ≤ 2^-7·|want| + 1e-5 at every element (both round float32
results to bf16, at most one ulp apart; the bf16 kernel multiplies P·V as
bf16 hi + lo parts on the tensor cores for that reason).  The SSD chunk step: max |Δ| ≤
1e-4·max(1, max |want|) on each output (float32 sums and the cumsum in
another order); with dt in Mamba2's range, where decay and gate do not
underflow, those two within 1e-4·|want| at every element.  The fused loop
(``daemon="sharded"`` + ``upper="mesh"``) is held against the host loop and
``run_reference``, autotuned and at four logical devices too, and the async
loop at eight against ``run_reference`` with its launches; every point
of the card's autotune space gives the same aggregate; and the pipelined
daemon (three CUDA streams) is held against the blocked daemon and
``run_reference``.  This file imports no JAX, so it runs on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch import plug
from repro_torch.core import template
from repro_torch.graph import algorithms, generate
from repro_torch.graph.compaction import build_csr_tiles
from repro_torch.kernels import autotune
from repro_torch.kernels import edge_block as ebk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
# gen_op → (program, state width K)
GEN_PROGRAMS = {
    "pr_div_deg": ("pagerank", 1),
    "add_weight": ("sssp_bf", 3),
    "mul_weight": ("label_prop", 3),
    "copy_src": ("wcc", 1),
    "add_one": ("bfs", 1),
}
MONOIDS = ("sum", "min", "max", "or")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph():
    return generate.rmat(96, 700, seed=5)


def _program(gen_op, monoid):
    name, k = GEN_PROGRAMS[gen_op]
    kw = {"sssp_bf": {"sources": list(range(k))},
          "label_prop": {"num_classes": k}}.get(name, {})
    prog = getattr(algorithms, name)(_graph(), **kw)
    assert prog.gen_op == gen_op and prog.state_width == k
    return dataclasses.replace(prog, monoid=template.MONOIDS[monoid])


def _values(rng, shape, monoid):
    if monoid == "or":  # {0, 1} indicators
        return (rng.random(shape) < 0.5).astype(np.float32)
    return rng.uniform(0.0, 10.0, shape).astype(np.float32)


def _block_inputs(dev, seed, k, monoid, nb=3, vb=40, b=64):
    rng = np.random.default_rng(seed)
    arrs = (_values(rng, (nb, vb, k), monoid),
            rng.uniform(0.0, 5.0, (nb, vb, 1)).astype(np.float32),
            rng.integers(0, vb, (nb, b)).astype(np.int32),
            rng.integers(0, vb, (nb, b)).astype(np.int32),
            rng.uniform(1.0, 10.0, (nb, b, 1)).astype(np.float32),
            (rng.random((nb, b)) < 0.8).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _tile_inputs(dev, seed, k, monoid, n=80, e=600, edge_tile=32):
    """Compacted tiles with a hub row split across tiles, padded tails and
    a random frontier mask over the live edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.concatenate([np.zeros(e // 6, np.int32),
                          rng.integers(0, n, e - e // 6).astype(np.int32)])
    w = rng.uniform(1.0, 10.0, e).astype(np.float32)
    ts = build_csr_tiles(src, dst, w, n, edge_tile=edge_tile)
    state = _values(rng, (n, k), monoid)
    aux = rng.uniform(0.0, 5.0, (n, 1)).astype(np.float32)
    emask = ts.emask & (rng.random(ts.emask.shape) < 0.8)
    arrs = (state[ts.svids], aux[ts.svids], state[ts.rows], ts.lsrc, ts.seg,
            ts.w, emask.astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


# In-degrees of consecutive dst rows, in dst order: runs of 1, 31, 32, 33,
# 64, 65, 511 and 512 edges around a warp's 32 lanes and a tile's 512
# slots; a hub row of 700 edges, split across two tiles; a row whose edges
# are all masked (SEAM_DEAD_DST); and tiles cut early, whose tails are
# padding.
SEAM_DEGREES = (1, 31, 32, 33, 64, 65, 511, 512, 700, 40, 1, 2, 300)
SEAM_DEAD_DST = 9 * 7 + 3


def seam_tiles(seed: int, k: int, monoid: str):
    """The CSR tiles (ET 512) of SEAM_DEGREES over 2,048 vertices, and the
    csr_tile arguments as numpy arrays: K-wide source states and a frontier
    mask with SEAM_DEAD_DST's edges and 10% of the others dead."""
    rng = np.random.default_rng(seed)
    n = 2048
    dst = np.repeat(np.arange(len(SEAM_DEGREES), dtype=np.int32) * 7 + 3,
                    SEAM_DEGREES)
    src = rng.integers(0, n, dst.size).astype(np.int32)
    w = rng.uniform(1.0, 10.0, dst.size).astype(np.float32)
    ts = build_csr_tiles(src, dst, w, n, edge_tile=512)
    state = _values(rng, (n, k), monoid)
    aux = rng.uniform(0.0, 5.0, (n, 1)).astype(np.float32)
    emask = (ts.emask & (ts.gdst != SEAM_DEAD_DST)
             & (rng.random(ts.emask.shape) < 0.9))
    return ts, (state[ts.svids], aux[ts.svids], state[ts.rows], ts.lsrc,
                ts.seg, ts.w, emask.astype(np.float32))


def _assert_match(monoid, got, want, got_c, want_c):
    assert torch.equal(got_c, want_c)
    if monoid == "sum":
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("gen_op", sorted(GEN_PROGRAMS))
def test_edge_block_kernel_matches_plain(cuda, gen_op, monoid):
    prog = _program(gen_op, monoid)
    arrs = _block_inputs(cuda, 17, prog.state_width, monoid)
    before = ebk.edge_block.launches
    got, got_c = ebk.edge_block(*arrs, program=prog)
    want, want_c = ebk.edge_block_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    assert ebk.edge_block.launches == before + 1
    _assert_match(monoid, got, want, got_c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("gen_op", sorted(GEN_PROGRAMS))
def test_csr_tile_kernel_matches_plain(cuda, gen_op, monoid):
    prog = _program(gen_op, monoid)
    arrs = _tile_inputs(cuda, 19, prog.state_width, monoid)
    before = ebk.csr_tile.launches
    got, got_c = ebk.csr_tile(*arrs, program=prog)
    want, want_c = ebk.csr_tile_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    assert ebk.csr_tile.launches == before + 1
    _assert_match(monoid, got, want, got_c, want_c)


@pytest.mark.cuda
def test_csr_tile_kernel_on_padded_dead_tiles(cuda):
    """Dead tiles (all padding) and wide K read the identity everywhere."""
    prog = _program("add_weight", "min")
    arrs = _tile_inputs(cuda, 23, 3, "min")
    arrs[-1] = torch.zeros_like(arrs[-1])  # every edge masked
    got, got_c = ebk.csr_tile(*arrs, program=prog)
    assert torch.equal(got_c, torch.zeros_like(got_c))
    assert bool((got == prog.monoid.identity).all())


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", MONOIDS)
def test_csr_tile_kernel_on_stacked_shards_with_whole_dead_tiles(cuda,
                                                                  monoid):
    """The sharded daemon's launch: two shards' tile sets padded to one
    (nt, RT, ST) envelope and stacked, so the smaller shard ends in whole
    dead tiles (seg, rows and svids 0, emask False) and every tile has
    padded rows and sources."""
    from repro_torch.graph.compaction import pad_tileset

    prog = _program("add_weight", monoid)
    rng = np.random.default_rng(37)
    n = 80
    sets = []
    for e in (600, 90):
        src = rng.integers(0, n, e).astype(np.int32)
        dst = np.concatenate([np.zeros(e // 6, np.int32),
                              rng.integers(0, n, e - e // 6).astype(np.int32)])
        sets.append(build_csr_tiles(src, dst, rng.uniform(1.0, 10.0, e)
                                    .astype(np.float32), n, edge_tile=32))
    env = dict(num_tiles=max(t.num_tiles for t in sets),
               row_tile=max(t.row_tile for t in sets),
               src_tile=max(t.src_tile for t in sets))
    assert sets[1].num_tiles < env["num_tiles"]  # whole dead tiles
    padded = [pad_tileset(t, **env) for t in sets]
    stack = {f: np.concatenate([getattr(t, f) for t in padded])
             for f in ("rows", "seg", "lsrc", "svids", "w", "emask")}
    state = _values(rng, (n, 3), monoid)
    aux = rng.uniform(0.0, 5.0, (n, 1)).astype(np.float32)
    emask = stack["emask"] & (rng.random(stack["emask"].shape) < 0.8)
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        state[stack["svids"]], aux[stack["svids"]], state[stack["rows"]],
        stack["lsrc"], stack["seg"], stack["w"], emask.astype(np.float32))]
    before = ebk.csr_tile.launches
    got, got_c = ebk.csr_tile(*arrs, program=prog)
    want, want_c = ebk.csr_tile_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    assert ebk.csr_tile.launches == before + 1
    _assert_match(monoid, got, want, got_c, want_c)
    dead = slice(env["num_tiles"] + sets[1].num_tiles, None)
    assert not bool(got_c[dead].any())
    assert bool((got[dead] == prog.monoid.identity).all())


@pytest.mark.cuda
def test_kernels_reject_program_without_gen_op(cuda):
    prog = dataclasses.replace(_program("copy_src", "min"), gen_op=None)
    with pytest.raises(ValueError, match="gen_op"):
        ebk.edge_block(*_block_inputs(cuda, 3, 1, "min"), program=prog)
    with pytest.raises(ValueError, match="gen_op"):
        ebk.csr_tile(*_tile_inputs(cuda, 3, 1, "min"), program=prog)


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "bfs", "wcc", "pagerank",
                                       "label_prop"])
def test_middleware_kernels_match_reference(cuda, prog_name):
    g = _graph()
    if prog_name == "wcc":
        g = g.with_reverse_edges()
    prog = algorithms.ALGORITHMS[prog_name](g)
    ref, _ = plug.run_reference(g, prog, max_iterations=12, device=cuda)
    before = (ebk.csr_tile.launches, ebk.edge_block.launches)
    for daemon in (plug.VectorizedDaemon(kernel="cuda",
                                         csr_config=ops.CSRConfig()),
                   plug.BlockedDaemon(kernel="cuda")):
        mw = plug.Middleware(g, prog, daemon=daemon, num_shards=2,
                             options=plug.PlugOptions(block_size=128),
                             device=cuda)
        res = mw.run(max_iterations=12)
        if prog.monoid.idempotent:
            np.testing.assert_array_equal(res.state, ref)
        else:
            np.testing.assert_allclose(res.state, ref, rtol=1e-5, atol=1e-7)
    assert ebk.csr_tile.launches > before[0]
    assert ebk.edge_block.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "bfs", "wcc", "pagerank",
                                       "label_prop"])
def test_fused_loop_matches_host_loop_and_reference(cuda, prog_name):
    """daemon="sharded" + upper="mesh" drives the fused loop on the card:
    kernel="cuda" launches csr_tile exactly once an iteration over all
    shards' tiles, kernel="reference" not at all, and both agree with the
    host loop and run_reference."""
    g = _graph()
    if prog_name == "wcc":
        g = g.with_reverse_edges()
    prog = algorithms.ALGORITHMS[prog_name](g)
    opts = plug.PlugOptions(block_size=128)
    ref, _ = plug.run_reference(g, prog, max_iterations=12, device=cuda)
    host = plug.Middleware(
        g, prog, daemon=plug.VectorizedDaemon(kernel="cuda",
                                              csr_config=ops.CSRConfig()),
        num_shards=4, options=opts, device=cuda).run(max_iterations=12)
    for kernel in ("cuda", "reference"):
        mw = plug.Middleware(g, prog, upper="mesh", num_shards=4,
                             daemon=plug.get_daemon(
                                 "sharded", kernel=kernel,
                                 csr_config=ops.CSRConfig()),
                             options=opts, device=cuda)
        assert mw._fused_kind == "bsp"
        before = ebk.csr_tile.launches
        res = mw.run(max_iterations=12)
        launched = ebk.csr_tile.launches - before
        assert launched == (res.iterations if kernel == "cuda" else 0)
        assert all(r["fused"] for r in res.per_iteration)
        assert res.iterations == host.iterations
        if prog.monoid.idempotent:
            np.testing.assert_array_equal(res.state, ref)
            np.testing.assert_array_equal(res.state, host.state)
        else:
            np.testing.assert_allclose(res.state, ref, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(res.state, host.state, rtol=1e-5,
                                       atol=1e-7)


@pytest.fixture
def autotune_cache():
    """The process-wide autotune memo, cleared before and after."""
    autotune.CACHE.clear()
    yield autotune.CACHE
    autotune.CACHE.clear()


def _assert_same_state(prog, got, want, rtol=1e-5, atol=1e-7):
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_tiled_plain_twin_raises_on_cuda_tensors(cuda):
    """lowering="torch" tiled is the kernel's plain twin: it never runs on
    the card; the flat merge (plain PyTorch outside the kernel) does."""
    g = _graph()
    prog = algorithms.sssp_bf(g, sources=[0, 1])
    ts = build_csr_tiles(g.src, g.dst, g.weights, g.num_vertices,
                         edge_tile=64)
    csr = {k: torch.from_numpy(v).to(cuda) for k, v in ts.arrays().items()}
    state, aux = (torch.from_numpy(a).to(cuda) for a in prog.init(g))
    launches = ebk.csr_tile.launches
    for merge in ("sorted", "onehot"):
        with pytest.raises(ValueError, match="CPU tensors only"):
            ops.csr_aggregate(state, aux, csr, program=prog,
                              num_vertices=g.num_vertices,
                              config=ops.CSRConfig(edge_tile=64,
                                                   lowering="torch",
                                                   merge=merge))
    flat = ops.csr_aggregate(state, aux, csr, program=prog,
                             num_vertices=g.num_vertices,
                             config=ops.CSRConfig(edge_tile=64,
                                                  lowering="torch",
                                                  merge="flat"))
    tiled = ops.csr_aggregate(state, aux, csr, program=prog,
                              num_vertices=g.num_vertices,
                              config=ops.CSRConfig(edge_tile=64))
    assert ebk.csr_tile.launches == launches + 1
    for a, b in zip(flat, tiled):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank", "label_prop",
                                       "bfs"])
def test_every_card_space_point_gives_the_same_aggregate(cuda, prog_name):
    """Each point of the card's space, at its own tile cut, gives the
    aggregate of the plain version at CSRConfig() on the CPU."""
    g = _graph()
    prog = algorithms.ALGORITHMS[prog_name](g)
    state, aux = prog.init(g)
    state = np.random.default_rng(2).uniform(
        0.0, 10.0, state.shape).astype(np.float32)

    def run(config, dev):
        ts = build_csr_tiles(g.src, g.dst, g.weights, g.num_vertices,
                             edge_tile=config.edge_tile)
        csr = {k: torch.from_numpy(v).to(dev)
               for k, v in ts.arrays().items()}
        agg, cnt = ops.csr_aggregate(
            torch.from_numpy(state).to(dev), torch.from_numpy(aux).to(dev),
            csr, program=prog, num_vertices=g.num_vertices, config=config)
        return agg.cpu().numpy(), cnt.cpu().numpy()

    want, want_c = run(ops.CSRConfig(), "cpu")
    for config in autotune.default_space(cuda):
        got, got_c = run(config, cuda)
        np.testing.assert_array_equal(got_c, want_c, err_msg=config.label)
        _assert_same_state(prog, got, want, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_autotuned_loops_match_reference(cuda, prog_name, autotune_cache):
    """With csr_config=None the daemons sweep the card's space: the fused
    loop (tuned on the largest shard) and the host loop match
    run_reference, and the fused loop launches csr_tile once an iteration
    if a kernel point won, never if the flat merge won."""
    g = _graph()
    prog = algorithms.ALGORITHMS[prog_name](g)
    opts = plug.PlugOptions(block_size=128)
    ref, _ = plug.run_reference(g, prog, max_iterations=12, device=cuda)
    mw = plug.Middleware(g, prog, upper="mesh", num_shards=4,
                         daemon=plug.ShardedDaemon(kernel="cuda"),
                         options=opts, device=cuda)
    chosen = mw.daemon._csr_config
    assert chosen in autotune.CUDA_SPACE and autotune_cache.sweeps == 1
    before = ebk.csr_tile.launches
    res = mw.run(max_iterations=12)
    launched = ebk.csr_tile.launches - before
    assert launched == (0 if chosen.merge == "flat" else res.iterations)
    _assert_same_state(prog, res.state, ref)
    host = plug.Middleware(g, prog, daemon=plug.VectorizedDaemon(
        kernel="cuda"), num_shards=4, options=opts, device=cuda)
    _assert_same_state(prog, host.run(max_iterations=12).state, ref)
    assert host.daemon._csr_config in autotune.CUDA_SPACE


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank", "wcc"])
def test_mesh4_matches_mesh1_on_the_card(cuda, prog_name):
    """Four logical devices on the card: the same state as one (sums
    within rtol 1e-4), the same records, one csr_tile launch an
    iteration."""
    g = _graph()
    if prog_name == "wcc":
        g = g.with_reverse_edges()
    prog = algorithms.ALGORITHMS[prog_name](g)
    runs = {}
    for m in (1, 4):
        mw = plug.Middleware(
            g, prog, upper=plug.MeshUpperSystem(mesh=m), num_shards=4,
            daemon=plug.ShardedDaemon(kernel="cuda",
                                      csr_config=ops.CSRConfig()),
            options=plug.PlugOptions(block_size=128), device=cuda)
        assert mw.daemon.m == m
        before = ebk.csr_tile.launches
        runs[m] = mw.run(max_iterations=12)
        assert ebk.csr_tile.launches - before == runs[m].iterations
    _assert_same_state(prog, runs[4].state, runs[1].state, rtol=1e-4)
    assert runs[4].per_iteration == runs[1].per_iteration


ASYNC_ARMS = {"eager": dict(theta0=0.0, decay=0.5),
              "holding": dict(theta0=10.0, decay=0.9),
              "buckets": dict(theta0=10.0, decay=0.9, bucket_k=8)}


def executed_runs(rec, shards):
    """The devices that ran their body in one async record — those that
    ran a tile: an executing device's backlog holds a source whose edges
    it owns — and the number of maximal runs of consecutive ones."""
    m = rec["devices"]
    per = shards // m
    ran = [sum(rec["shard_blocks_run"][g * per:(g + 1) * per]) > 0
           for g in range(m)]
    runs = sum(1 for g in range(m) if ran[g] and (g == 0 or not ran[g - 1]))
    return ran, runs


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name, arm", [
    ("sssp_bf", "eager"), ("sssp_bf", "holding"), ("sssp_bf", "buckets"),
    ("pagerank", "eager")])
def test_async_loop_on_the_card(cuda, prog_name, arm):
    """The fused async loop at mesh=8 on the card (the CPU tests' graph):
    run_reference's fixed point (sssp bit for bit, pagerank's 12
    iterations within rtol 1e-4), held devices ran no tile, the device
    bodies run equal gen_run, and csr_tile launched once per run of
    consecutive executing devices in every iteration."""
    g = generate.rmat(256, 2048, seed=9)
    prog = algorithms.ALGORITHMS[prog_name](g)
    max_it = 12 if prog_name == "pagerank" else 300
    daemon = plug.ShardedDaemon(kernel="cuda", csr_config=ops.CSRConfig())
    mw = plug.Middleware(g, prog, daemon=daemon, upper=plug.MeshUpperSystem(
        mesh=8), num_shards=8, model=plug.AsyncModel(**ASYNC_ARMS[arm]),
        options=plug.PlugOptions(block_size=64), device=cuda)
    assert mw._fused_kind == "async"
    per_call = []
    run_all = daemon.run_all_shards

    def counted(*args, **kwargs):
        before = ebk.csr_tile.launches
        out = run_all(*args, **kwargs)
        per_call.append(ebk.csr_tile.launches - before)
        return out

    daemon.run_all_shards = counted
    daemon.instrument = True
    daemon.reset_counters()
    res = mw.run(max_iterations=max_it)
    ref, _ = plug.run_reference(g, prog, max_iterations=max_it, device=cuda)
    _assert_same_state(prog, res.state, ref, rtol=1e-4)
    assert res.converged == (prog_name != "pagerank")
    holds = 0
    for rec, launched in zip(res.per_iteration, per_call, strict=True):
        ran, runs = executed_runs(rec, 8)
        assert sum(ran) == rec["gen_run"] == 8 - rec["gen_skipped"]
        assert launched == runs, (rec["iteration"], launched, runs)
        for dev, may_run in enumerate(rec["run_mask"]):
            holds += not may_run
            assert may_run or not ran[dev]
    assert daemon.gen_invocations == sum(r["gen_run"]
                                         for r in res.per_iteration)
    if arm == "eager":
        assert holds == 0
    else:
        assert holds > 0
    if arm == "buckets":
        assert daemon.bucket_invocations > 0


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "bfs", "wcc", "pagerank",
                                       "label_prop"])
def test_pipelined_daemon_matches_blocked_daemon(cuda, prog_name):
    """PipelinedDaemon(kernel="cuda") on three streams against
    BlockedDaemon(kernel="cuda") and run_reference: the same blocks, so the
    same edge_block launches; min bit-equal, sum within rtol."""
    g = _graph()
    if prog_name == "wcc":
        g = g.with_reverse_edges()
    prog = algorithms.ALGORITHMS[prog_name](g)
    ref, _ = plug.run_reference(g, prog, max_iterations=12, device=cuda)
    runs = {}
    for cls in (plug.BlockedDaemon, plug.PipelinedDaemon):
        mw = plug.Middleware(g, prog, daemon=cls(kernel="cuda"),
                             num_shards=2,
                             options=plug.PlugOptions(block_size=64),
                             device=cuda)
        mw.run(max_iterations=1)  # the warm-up block runs once per bind
        before = ebk.edge_block.launches
        res = mw.run(max_iterations=12)
        runs[cls.name] = (res, ebk.edge_block.launches - before)
        key = "pipeline" if cls is plug.PipelinedDaemon else "sequential"
        recs = [r for it in res.per_iteration for r in it.get(key, ())]
        assert recs and all(set(r["device"]) == set(r["busy"]) for r in recs)
        if prog.monoid.idempotent:
            np.testing.assert_array_equal(res.state, ref)
        else:
            np.testing.assert_allclose(res.state, ref, rtol=1e-5, atol=1e-7)
    (blocked, nb), (piped, npiped) = runs["blocked"], runs["pipelined"]
    assert nb == npiped > 0
    assert piped.iterations == blocked.iterations
    assert piped.stats.as_dict() == blocked.stats.as_dict()
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(piped.state, blocked.state)
    else:
        np.testing.assert_allclose(piped.state, blocked.state, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.cuda
def test_streaming_daemon_computes_on_its_own_stream(cuda):
    """The block program runs on the daemon's compute stream, never the
    default stream, and in the pipeline's compute thread."""
    g = _graph()
    prog = algorithms.sssp_bf(g)
    daemon = plug.PipelinedDaemon(kernel="cuda")
    mw = plug.Middleware(g, prog, daemon=daemon,
                         options=plug.PlugOptions(block_size=64),
                         device=cuda)
    mw.run(max_iterations=1)
    seen = []
    inner = daemon.block_fn

    def block_fn(*args):
        seen.append((torch.cuda.current_stream(cuda).stream_id,
                     threading.get_ident()))
        return inner(*args)

    daemon.block_fn = block_fn
    res = mw.run()
    ref, _ = plug.run_reference(g, prog, device=cuda)
    np.testing.assert_array_equal(res.state, ref)
    assert seen
    default = torch.cuda.default_stream(cuda).stream_id
    assert {s for s, _ in seen} == {daemon.streams[1].stream_id} != {default}
    assert threading.get_ident() not in {t for _, t in seen}


class _SlowDownload(plug.PipelinedDaemon):
    """Queues a sleep kernel on the copy-in stream before each block's
    copies, so each block arrives late: a compute stage that did not wait
    for its block's event would read the slot's previous block."""

    def _cuda_stages(self, *args):
        download, compute, upload = super()._cuda_stages(*args)

        def slow_download(i, slot):
            with torch.cuda.stream(self.streams[0]):
                torch.cuda._sleep(2_000_000)
            download(i, slot)

        return slow_download, compute, upload


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_streaming_stages_wait_for_a_late_download(cuda, prog_name):
    g = _graph()
    prog = algorithms.ALGORITHMS[prog_name](g)
    ref, _ = plug.run_reference(g, prog, max_iterations=6, device=cuda)
    res = plug.Middleware(g, prog, daemon=_SlowDownload(kernel="cuda"),
                          options=plug.PlugOptions(block_size=64),
                          device=cuda).run(max_iterations=6)
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(res.state, ref)
    else:
        np.testing.assert_allclose(res.state, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_csr_tile_kernel_stages_wide_tiles_beyond_48kb(cuda):
    """Tiles wider than the kernel's 512-slot round, at K=16: ET=1024 and
    ET=4096 run in several rounds, carrying open runs from one to the
    next, and match the plain version."""
    prog = algorithms.sssp_bf(_graph(), sources=list(range(16)))
    for seed, e, et in ((29, 4000, 1024), (31, 5000, 4096)):
        arrs = _tile_inputs(cuda, seed, 16, "min", n=300, e=e, edge_tile=et)
        got, got_c = ebk.csr_tile(*arrs, program=prog)
        want, want_c = ebk.csr_tile_plain(*arrs, program=prog)
        torch.cuda.synchronize()
        _assert_match("min", got, want, got_c, want_c)


# Every K the kernels' dispatch treats apart: template constants 1, 4, 8;
# the run-time K of the others; in the edge block's sum, staging rows of
# one float2 (K=1), one float4 (2, 3), float4s and a scalar count (4, 8) or
# float4s alone (5, 7), up to kMaxK = 16.
SEAM_KS = (1, 2, 3, 4, 5, 7, 8, 9, 16)


def _sssp_program(k, monoid):
    prog = algorithms.sssp_bf(_graph(), sources=list(range(k)))
    return dataclasses.replace(prog, monoid=template.MONOIDS[monoid])


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("k", SEAM_KS)
def test_csr_tile_kernel_seams(cuda, k, monoid):
    """Runs of 1..700 slots around warps and tiles, a split hub row, a dead
    run and padded tails (SEAM_DEGREES), at every K of the dispatch."""
    prog = _sssp_program(k, monoid)
    _, arrs = seam_tiles(k, k, monoid)
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrs]
    got, got_c = ebk.csr_tile(*arrs, program=prog)
    want, want_c = ebk.csr_tile_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    _assert_match(monoid, got, want, got_c, want_c)


def _hot_block_inputs(dev, seed, k, monoid, nb, b, vb=40):
    """Edge blocks whose destinations put a third of the edges on one hot
    row; b need not be a multiple of 4."""
    arrs = _block_inputs(dev, seed, k, monoid, nb=nb, vb=vb, b=b)
    hot = torch.rand((nb, b), generator=torch.Generator().manual_seed(seed))
    arrs[3] = torch.where(hot.to(dev) < 1 / 3, torch.zeros_like(arrs[3]),
                          arrs[3]).contiguous()
    return arrs


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("k", SEAM_KS)
@pytest.mark.parametrize("nb,b", [(1, 256), (3, 256), (3, 61)],
                         ids=["nb1", "nb3", "nb3-b61"])
def test_edge_block_kernel_seams(cuda, nb, b, k, monoid):
    """One block (as BlockedDaemon launches it) and three, with one hot
    destination row, at every K of the dispatch; b=61 takes the scalar
    loads."""
    prog = _sssp_program(k, monoid)
    arrs = _hot_block_inputs(cuda, 41 + k, k, monoid, nb, b)
    before = ebk.edge_block.launches
    got, got_c = ebk.edge_block(*arrs, program=prog)
    want, want_c = ebk.edge_block_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    assert ebk.edge_block.launches == before + 1
    _assert_match(monoid, got, want, got_c, want_c)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "min"])
def test_graph_kernels_take_unaligned_views(cuda, monoid):
    """Tensors that do not start on 16 bytes run the run-time-K kernels
    with scalar loads, and give the same result."""
    prog = _sssp_program(4, monoid)
    _, tiles = seam_tiles(4, 4, monoid)
    tiles = [_unaligned(torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
             for a in tiles]
    got, got_c = ebk.csr_tile(*tiles, program=prog)
    want, want_c = ebk.csr_tile_plain(*tiles, program=prog)
    blocks = [_unaligned(a) for a in _hot_block_inputs(cuda, 5, 4, monoid,
                                                        3, 256)]
    bgot, bgot_c = ebk.edge_block(*blocks, program=prog)
    bwant, bwant_c = ebk.edge_block_plain(*blocks, program=prog)
    torch.cuda.synchronize()
    _assert_match(monoid, got, want, got_c, want_c)
    _assert_match(monoid, bgot, bwant, bgot_c, bwant_c)


# --------------------------------------------------------------------------
# flash attention and the SSD chunk step
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 192, 1000])  # 1000: not a multiple of 64
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (6, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_flash_attention_kernel_matches_plain(cuda, d, dtype, causal, hq,
                                              hkv, s):
    gen = torch.Generator(device=cuda).manual_seed(d + s + hq)
    q, k, v = (torch.randn((2, h, s, d), generator=gen, device=cuda
                           ).to(dtype) for h in (hq, hkv, hkv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    # bf16: both round float32 results to bf16, at most one ulp apart
    rtol, atol = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else (0, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# (B, Hq, Hkv, S, D): the seams of the bf16 Hopper kernel — one key and
# one partial tile (S=1, 17), a ragged last tile whose rows past S belong to
# the next head in memory (B=2, S=1000: only the 3-D tensor map's
# zero-fill keeps them out), a long causal walk through the stage ring
# (S=4096), qwen2-72b's 8:1 GQA at D=128, and zamba2-2.7b's D=80, which
# runs the D=128 kernel with TMA zero-filling columns 80..127
BF16_SEAMS = [
    (1, 2, 1, 1, 128),
    (1, 4, 2, 17, 64),
    (2, 4, 4, 1000, 32),
    (2, 2, 2, 1000, 128),
    (1, 2, 1, 4096, 128),
    (1, 16, 2, 512, 128),
    (2, 4, 4, 1000, 80),
    (1, 8, 8, 4096, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d", BF16_SEAMS)
def test_flash_attention_bf16_kernel_seams(cuda, b, hq, hkv, s, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + d + hq)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda
                           ).to(torch.bfloat16) for h in (hq, hkv, hkv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    # one bf16 ulp per element, as in test_flash_attention_kernel_matches_plain
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=2.0 ** -7)


# (B, Hq, Hkv, S, D): the seams of the float32 3xTF32 kernel — one key and
# one partial tile (S=1, 17), a ragged last tile whose rows past S belong to
# the next head in memory (B=2, S=1000: only cp.async's zero-fill keeps them
# out), a long causal walk through the double buffer (S=4096), 8:1 GQA at
# D=128 (the instantiation with the most registers), and D=80, which runs
# the D=80 instantiation
F32_SEAMS = [
    (1, 2, 1, 1, 128),
    (1, 4, 2, 17, 64),
    (2, 4, 4, 1000, 32),
    (2, 2, 2, 1000, 128),
    (1, 2, 1, 4096, 64),
    (1, 16, 2, 512, 128),
    (2, 4, 4, 1000, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d", F32_SEAMS)
def test_flash_attention_f32_kernel_seams(cuda, b, hq, hkv, s, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + d + hq)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda)
               for h in (hq, hkv, hkv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    # as in test_flash_attention_kernel_matches_plain (float32 sums in
    # another order; three TF32 products keep float32's accuracy)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_kernel_head_dims(cuda, d, dtype, causal):
    """Every head dim the kernels take (multiples of 8 up to 128), each run
    by an instantiation at D >= d with zero columns past d; S=200 leaves a
    ragged last tile.  Tolerances as in
    test_flash_attention_kernel_matches_plain."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, h, 200, d), generator=gen, device=cuda
                           ).to(dtype) for h in (4, 2, 2))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else (0, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 136])  # not a multiple of 8; above 128
def test_flash_attention_kernel_refuses_other_head_dims(cuda, d):
    q = torch.zeros((1, 2, 64, d), device=cuda)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_refuses_unaligned_views(cuda, dtype):
    """Both kernels read 16 bytes at a time (cp.async, TMA): a contiguous
    view that starts off a 16-byte boundary is refused, not misread."""
    n = 2 * 64 * 16
    q = torch.randn(n + 1, device=cuda).to(dtype)[1:].view(1, 2, 64, 16)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


def _ssd_chunk_inputs(dev, seed, b, nc, l, h, p, g, n, dt="softplus"):
    """As tests/test_kernels.py makes them (dt = softplus(N(0,1))), or with
    dt log-uniform in Mamba2's range 1e-3..1e-1 ("mamba2"), where a chunk's
    decay and gate stay normal floats."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = 0.5 * randn(b, nc, l, h, p)
    if dt == "softplus":
        dts = torch.nn.functional.softplus(randn(b, nc, l, h))
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        dts = torch.exp(lo + (hi - lo) * torch.rand((b, nc, l, h),
                                                    generator=gen,
                                                    device=dev))
    return (x, dts, -torch.exp(0.3 * randn(h)),
            0.3 * randn(b, nc, l, g, n), 0.3 * randn(b, nc, l, g, n))


def _assert_f32_close(got, want, name, live=False):
    """max |Δ| ≤ 1e-4·max(1, max |want|); with ``live``, |Δ| ≤ 1e-4·|want|
    at every element, and every |want| a normal float."""
    if live:
        assert float(want.abs().min()) > 1e-30, f"{name}: underflows"
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0, msg=name)
        return
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert err <= tol, f"{name}: max |diff| {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["softplus", "mamba2"])
@pytest.mark.parametrize("chunk", [16, 64, 96, 256])  # 96: not whole tiles
@pytest.mark.parametrize("groups", ["one", "per_head"])
@pytest.mark.parametrize("h,p,n", [(4, 32, 16), (2, 64, 128), (2, 16, 8),
                                   (2, 128, 32)])
def test_ssd_chunk_kernel_matches_plain(cuda, chunk, groups, h, p, n, dt):
    g = 1 if groups == "one" else h
    arrs = _ssd_chunk_inputs(cuda, chunk + h, 2, 3, chunk, h, p, g, n, dt)
    before = ssd.ssd_chunk.launches
    got = ssd.ssd_chunk(*arrs)
    want = ssd.ssd_chunk_plain(*arrs)
    torch.cuda.synchronize()
    assert ssd.ssd_chunk.launches == before + 1
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        assert gt.shape == wt.shape, name
        _assert_f32_close(gt, wt, name,
                          live=dt == "mamba2" and name in ("decay", "gate"))


# (label, B, NC, L, H, P, G, N): the 3xTF32 kernel's seams — N not a
# multiple of 8 (and of 4: rows read one float at a time), chunks that are
# not whole 64-row tiles, head blocks (R = min(8, H/G) heads sharing one
# C·Bᵀ panel) inside groups, a partial last head block, N past one 64-row
# state block and past any one stage, and mamba2-1.3b's shape
SSD_SEAMS = [("n5", 2, 2, 96, 4, 32, 1, 5),
             ("n12-g2", 2, 2, 64, 4, 64, 2, 12),
             ("l1", 2, 3, 1, 4, 32, 1, 16),
             ("l17", 2, 3, 17, 4, 16, 4, 8),
             ("h8-g2", 1, 2, 128, 8, 32, 2, 16),
             ("h6-g1", 1, 2, 128, 6, 32, 1, 16),
             ("h12-g1-partial", 1, 2, 160, 12, 16, 1, 8),
             ("n1000", 1, 1, 128, 2, 32, 1, 1000),
             ("mamba2-1.3b", 1, 2, 256, 64, 64, 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["softplus", "mamba2"])
@pytest.mark.parametrize("label,b,nc,l,h,p,g,n", SSD_SEAMS,
                         ids=[c[0] for c in SSD_SEAMS])
def test_ssd_chunk_kernel_seams(cuda, label, b, nc, l, h, p, g, n, dt):
    arrs = _ssd_chunk_inputs(cuda, l + h + n, b, nc, l, h, p, g, n, dt)
    before = ssd.ssd_chunk.launches
    got = ssd.ssd_chunk(*arrs)
    want = ssd.ssd_chunk_plain(*arrs)
    torch.cuda.synchronize()
    assert ssd.ssd_chunk.launches == before + 1
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        assert gt.shape == wt.shape, name
        _assert_f32_close(gt, wt, f"{label} {name}",
                          live=dt == "mamba2" and name in ("decay", "gate"))


@pytest.mark.cuda
def test_ssd_chunk_kernel_reads_unaligned_views(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary are read one float
    at a time, and give the same result."""
    arrs = [_unaligned(t) for t in _ssd_chunk_inputs(cuda, 7, 2, 2, 96, 4,
                                                      32, 2, 16)]
    assert all(t.is_contiguous() for t in arrs)
    assert arrs[0].data_ptr() % 16 != 0 and arrs[3].data_ptr() % 16 != 0
    got = ssd.ssd_chunk(*arrs)
    want = ssd.ssd_chunk_plain(*arrs)
    torch.cuda.synchronize()
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        _assert_f32_close(gt, wt, name)


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_chunk_over_shared_memory(cuda):
    """The kernel's shared memory grows with L (its C·Bᵀ panel) and not
    with N: a 1024-long chunk needs more than 227 KiB a CTA and is refused
    before anything launches."""
    arrs = _ssd_chunk_inputs(cuda, 0, 1, 1, 1024, 2, 64, 1, 8)
    before = ssd.ssd_chunk.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd.ssd_chunk(*arrs)
    assert ssd.ssd_chunk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dts", ["softplus", "mamba2"])
@pytest.mark.parametrize("g", [1, 4])
def test_ssd_scan_matches_sequential_reference(cuda, g, dts):
    b, s, h, p, n, chunk = 2, 512, 4, 32, 16, 256
    x, dt, a, bm, cm = _ssd_chunk_inputs(cuda, 3, b, 1, s, h, p, g, n, dts)
    x, dt, bm, cm = (t.reshape(b, s, *t.shape[3:]) for t in (x, dt, bm, cm))
    got = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    want = ref.ssd_scan_reference(x, dt, a, bm, cm)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_model_kernels_count_launches_on_cuda_tensors_only(cuda):
    q = torch.randn((1, 2, 64, 32))
    arrs = _ssd_chunk_inputs(torch.device("cpu"), 0, 1, 2, 16, 2, 16, 1, 8)
    before = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    fa.flash_attention(q, q, q)
    ssd.ssd_chunk(*arrs)
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == before
    fa.flash_attention(q.to(cuda), q.to(cuda), q.to(cuda))
    ssd.ssd_chunk(*(t.to(cuda) for t in arrs))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["bsp", "async"])
def test_kill_mid_run_on_the_card(cuda, model, autotune_cache):
    """Logical device 2 of 8 dies before iteration 3 with kernel="cuda" on
    the card: the run migrates to 4 devices and reaches run_reference's
    fixed point bit for bit, with no sweep (the pinned config stays), the
    re-ordered tilesets reused, and under BSP one csr_tile launch an
    iteration before and after the migration."""
    g = generate.rmat(256, 2048, seed=9)
    prog = algorithms.sssp_bf(g)
    daemon = plug.ShardedDaemon(kernel="cuda", csr_config=ops.CSRConfig())
    mw = plug.Middleware(
        g, prog, daemon=daemon, upper=plug.MeshUpperSystem(mesh=8),
        num_shards=8, model=model, options=plug.PlugOptions(block_size=64),
        failures=plug.FailureSchedule(kills=[(3, 2)]), device=cuda)
    reused, recut = daemon.tilesets_reused, daemon.tiles_recut
    before = ebk.csr_tile.launches
    res = mw.run(max_iterations=300)
    launched = ebk.csr_tile.launches - before
    (mig,) = [r["migration"] for r in res.per_iteration if "migration" in r]
    assert mig["killed"] == [2] and mig["devices_after"] == 4
    assert daemon.m == mw.upper.m == 4
    assert autotune.CACHE.sweeps == 0
    assert (daemon.tiles_recut, daemon.tilesets_reused) == (recut,
                                                            reused + 8)
    if model == "bsp":
        assert launched == res.iterations
    ref_state, _ = plug.run_reference(g, prog, device=cuda)
    np.testing.assert_array_equal(res.state, ref_state)


@pytest.mark.cuda
def test_mid_run_add_batch_recuts_one_shard_on_the_card(cuda,
                                                        autotune_cache):
    """An add batch whose sources own edges in shard 0 lands before
    iteration 3: one shard's tiles are recut, seven reused, and the run
    reaches run_reference's fixed point on the mutated graph."""
    g = generate.rmat(256, 2048, seed=9)
    prog = algorithms.sssp_bf(g)
    daemon = plug.ShardedDaemon(kernel="cuda", csr_config=ops.CSRConfig())
    probe = plug.Middleware(g, prog, num_shards=8, device="cpu",
                            options=plug.PlugOptions(block_size=64))
    rng = np.random.default_rng(0)
    srcs = rng.choice(np.unique(probe.partitions[0].src), 16)
    log = plug.MutationLog()
    for s, d in zip(srcs, rng.integers(0, g.num_vertices, 16)):
        log.add_edge(int(s), int(d), float(rng.uniform(1.0, 10.0)))
    mw = plug.Middleware(
        g, prog, daemon=daemon, upper=plug.MeshUpperSystem(mesh=8),
        num_shards=8, options=plug.PlugOptions(block_size=64),
        mutations=plug.MutationSchedule(events=[(3, log)]), device=cuda)
    reused, recut = daemon.tilesets_reused, daemon.tiles_recut
    before = ebk.csr_tile.launches
    res = mw.run()
    assert [r["iteration"] for r in res.per_iteration
            if "mutation" in r] == [3]
    assert (daemon.tiles_recut - recut, daemon.tilesets_reused - reused) \
        == (1, 7)
    assert ebk.csr_tile.launches - before == res.iterations
    assert autotune.CACHE.sweeps == 0
    ref_state, _ = plug.run_reference(mw.graph, algorithms.sssp_bf(mw.graph),
                                      device=cuda)
    np.testing.assert_array_equal(res.state, ref_state)


@pytest.mark.cuda
def test_dst_reading_program_through_the_card_sweep(cuda, autotune_cache):
    """A min program whose ``msg_gen`` reads the dst rows and names no
    ``gen_op`` (``min(s + w, d + 1)``) through ``daemon="cuda"`` with the
    default sweep: only the flat points are timed, the winner is one of
    them, and the state is run_reference's bit for bit."""
    g = generate.rmat(512, 4096, seed=5)
    prog = dataclasses.replace(
        algorithms.sssp_bf(g), name="dst_min", gen_op=None,
        msg_gen=lambda s, d, w, a: torch.minimum(s + w, d + 1.0))
    before = ebk.csr_tile.launches
    res = plug.Middleware(g, prog, daemon="cuda", num_shards=2,
                          options=plug.PlugOptions(block_size=64),
                          device=cuda).run()
    (entry,) = autotune_cache.report()["entries"]
    flat = {c.label for c in autotune.CUDA_SPACE if c.lowering == "torch"}
    assert set(entry["table"]) == flat and entry["chosen"] in flat
    assert ebk.csr_tile.launches == before
    ref_state, ref_it = plug.run_reference(g, prog, device=cuda)
    np.testing.assert_array_equal(res.state, ref_state)
    assert res.iterations == ref_it


def _oocore_mw(g, prog, device, **oocore):
    return plug.Middleware(
        g, prog, daemon=plug.ShardedDaemon(kernel="cuda",
                                           csr_config=ops.CSRConfig()),
        upper=plug.MeshUpperSystem(mesh=4), num_shards=4,
        options=plug.PlugOptions(block_size=256), device=device,
        oocore=plug.OocoreConfig(**oocore) if oocore else None)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_uploader_on_the_card(cuda, prefetch):
    """Pinned sources, copies on the side stream with prefetch (on the
    compute stream without), two device slots (one without prefetch)
    allocated once and overwritten after, so the device's allocations stop
    growing after the first uploads, at most two groups live, 0 ≤ overlap
    ≤ 1 and exactly 0 without prefetch, and the groups' bytes intact."""
    from repro_torch import oocore

    g = generate.rmat(4096, 65536, seed=2)
    mw = _oocore_mw(g, algorithms.sssp_bf(g), cuda, num_super_shards=4,
                    hot_fraction=0.25, prefetch=prefetch)
    d = mw.daemon
    assert all(t.is_pinned() for grp in d._cold for t in grp.values())
    streams = []

    def upload(i, out=None, copy=True):
        streams.append(torch.cuda.current_stream(cuda))
        return d.upload_super_shard(i, out=out, copy=copy)

    up = oocore.AsyncUploader(upload, cuda, prefetch=prefetch)
    spans, ptrs, allocated = [], set(), []
    for _ in range(2):
        for i in range(d.num_super_shards):
            grp, transfer, wait = up.take(i)
            if prefetch:
                up.request((i + 1) % d.num_super_shards)
            for k, t in grp["csr"].items():
                torch.testing.assert_close(t.cpu(), d._cold[i][k], rtol=0,
                                           atol=0)
            ptrs.add(grp["csr"]["gsrc"].data_ptr())
            spans.append((transfer, wait))
            up.release(i)
            allocated.append(torch.cuda.memory_allocated(cuda))
    torch.cuda.synchronize()
    compute = torch.cuda.current_stream(cuda)
    assert all((s != compute) == prefetch for s in streams)
    slots = 2 if prefetch else 1
    assert up.slot_allocations == len(ptrs) == slots
    assert up.slot_bytes == slots * sum(
        t.numel() * t.element_size() for t in d._cold[0].values())
    assert len(set(allocated[1:])) == 1
    assert 1 <= up.max_live_groups <= 2
    tr = sum(t.seconds() for t, _ in spans)
    wt = sum(w.seconds() for _, w in spans)
    assert tr > 0.0 and 0.0 <= wt
    overlap = 1.0 - wt / tr
    assert 0.0 <= overlap <= 1.0
    if not prefetch:
        assert all(t is w for t, w in spans) and overlap == 0.0
    up.close()


@pytest.mark.cuda
def test_uploader_slot_waits_for_its_reader(cuda):
    """A copy into a slot waits, on the device, for the compute stream to
    pass the last read of the group that held it: with every read queued
    behind a long sleep, each read still sees its own group's bytes."""
    from repro_torch import oocore

    g = generate.rmat(4096, 65536, seed=2)
    mw = _oocore_mw(g, algorithms.sssp_bf(g), cuda, num_super_shards=4,
                    hot_fraction=0.25)
    d = mw.daemon
    up = oocore.AsyncUploader(d.upload_super_shard, cuda)
    up.request(0)
    reads = []
    for i in range(d.num_super_shards):
        grp, _, _ = up.take(i)
        up.request((i + 1) % d.num_super_shards)
        torch.cuda._sleep(20_000_000)  # holds the compute stream ~10 ms
        reads.append({k: t.clone() for k, t in grp["csr"].items()})
        up.release(i)
    torch.cuda.synchronize()
    for i, got in enumerate(reads):
        for k, t in got.items():
            torch.testing.assert_close(t.cpu(), d._cold[i][k], rtol=0,
                                       atol=0)
    assert up.slot_allocations == 2
    up.close()


def _stall_trial(d, cuda):
    """With the copy stream held by a sleep, the compute stream stalls on
    the copy: the wait span reads it (above 0, at most the copy's start
    to end plus the sleep), and with nothing held it reads 0."""
    from repro_torch import oocore

    side = torch.cuda.Stream(device=cuda)
    up = oocore.AsyncUploader(d.upload_super_shard, cuda, stream=side)
    try:
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)  # ~10 ms before the copy starts
        _, transfer, wait = up.take(0)
        up.release(0)
        up.request(1)
        torch.cuda._sleep(20_000_000)  # the compute stream arrives late
        _, transfer1, wait1 = up.take(1)
        up.release(1)
        torch.cuda.synchronize()
        assert wait.seconds() > 1e-3 > transfer.seconds() > 0.0
        assert wait1.seconds() == 0.0 and transfer1.seconds() > 0.0
    finally:
        up.close()


def _stall_daemon(cuda):
    g = generate.rmat(4096, 65536, seed=2)
    return _oocore_mw(g, algorithms.sssp_bf(g), cuda, num_super_shards=4,
                      hot_fraction=0.25).daemon


@pytest.mark.cuda
def test_uploader_wait_reads_the_stall(cuda):
    """The stall trial once (:func:`_stall_trial`)."""
    _stall_trial(_stall_daemon(cuda), cuda)


STALL_TRIALS = 50


@pytest.mark.cuda
def test_uploader_wait_reads_the_stall_in_a_loop(cuda):
    """The stall trial ``STALL_TRIALS`` times, each on a fresh uploader
    after the allocator's cache is emptied, so that every trial's slots
    are allocated anew: every trial must hold."""
    d = _stall_daemon(cuda)
    failed = []
    for trial in range(STALL_TRIALS):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        try:
            _stall_trial(d, cuda)
        except AssertionError as e:
            failed.append((trial, str(e)))
    assert not failed, f"{len(failed)} of {STALL_TRIALS} trials: {failed}"


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks with CUDA tensors on the one card (a RankMesh's
    default device, cuda:{rank % device_count}): the fused and the host
    loop for sssp_bf and pagerank are replicated bit for bit on both ranks,
    equal the single-process ``mesh=2`` run (sssp_bf bit for bit, pagerank
    within rtol 1e-5 / atol 1e-6, iterations and records equal), and the
    fused loop launches ``csr_tile`` once an iteration on each rank."""
    ranks = _cuda_world(tmp_path, "gloo", 2)
    count = torch.cuda.device_count()
    assert [r["device"] for r in ranks] == [f"cuda:{r % count}"
                                            for r in range(2)]
    assert all(r["host_backend"] == "gloo" for r in ranks)


@pytest.mark.cuda
def test_one_nccl_rank_keeps_host_collectives_on_gloo(cuda, tmp_path):
    """A one-rank NCCL world on the card: the RankMesh merges device
    tensors over NCCL and the host loop's arrays over the gloo group it
    makes of the same ranks; both loops equal the single-process ``mesh=1``
    run, with one ``csr_tile`` launch an iteration in the fused loop."""
    (rank,) = _cuda_world(tmp_path, "nccl", 1)
    assert (rank["backend"], rank["host_backend"]) == ("nccl", "gloo")


@pytest.mark.cuda
def test_two_gloo_ranks_stream_out_of_core_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card stream a graph out of core, each its
    own shards' columns: the state bit-identical on both ranks and equal
    to the single-process ``mesh=2`` run and ``run_reference``, the
    per-iteration super-shards, hot columns and the world's hits and
    misses the single process's; each rank with its own side stream, at
    most two slots and two groups live, and ``csr_tile`` launched (hot >
    0) + uploads times a step."""
    import torch_ranks_worker as worker

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks

    build.library()  # built once here; the ranks load it
    g = generate.rmat(4096, 65536, seed=2)
    oocore = dict(num_super_shards=3, hot_fraction=0.25, prefetch=True)
    ranks = spawn_ranks(worker.cuda_oocore_world, 2, (g, 4, oocore),
                        backend="gloo",
                        init_method=f"file://{tmp_path}/init",
                        timeout_s=300.0)
    want = ranks[0]["single"]
    ref, _ = plug.run_reference(g, algorithms.sssp_bf(g), device="cuda")
    np.testing.assert_array_equal(want["state"], np.asarray(ref))
    world = ("super_shards", "hot_cols", "hot_hits", "cold_misses")
    for r in ranks:
        got = r["ranks"]
        assert got["state"].tobytes() == want["state"].tobytes()
        assert got["iterations"] == want["iterations"]
        assert [{k: c[k] for k in world} for c in got["counters"]] == \
            [{k: c[k] for k in world} for c in want["counters"]]
        assert got["side_stream"] and got["slots"] == 2
        assert 1 <= got["max_live_groups"] <= 2 and got["uploads"] > 0
        assert got["launches"] == got["want_launches"]


def _cuda_world(tmp_path, backend, world):
    """Runs ``torch_ranks_worker.cuda_world`` in ``world`` ranks of
    ``backend`` on the card and holds every rank's runs against rank 0's
    and the single-process ``mesh=world`` ones → the ranks' outputs."""
    import torch_ranks_worker as worker

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks

    build.library()  # built once here; the ranks load it
    g = generate.rmat(4096, 65536, seed=2)
    ranks = spawn_ranks(worker.cuda_world, world, (g, 4), backend=backend,
                        init_method=f"file://{tmp_path}/init",
                        timeout_s=300.0)
    assert all(r["backend"] == backend for r in ranks)
    for key, want in ranks[0]["single"].items():
        runs = [r["ranks"][key] for r in ranks]
        assert all(run["state"].tobytes() == runs[0]["state"].tobytes()
                   for run in runs)
        got = runs[0]
        assert (got["iterations"], got["records"], got["stats"]) == \
            (want["iterations"], want["records"], want["stats"])
        if key[1] == "pagerank":
            np.testing.assert_allclose(got["state"], want["state"],
                                       rtol=SUM_RTOL, atol=SUM_ATOL)
        else:
            np.testing.assert_array_equal(got["state"], want["state"])
        for r in ranks:
            launches = r["launches"][key]
            if key[0] == "fused":
                assert launches == got["iterations"], key
            else:
                assert launches > 0, key
    return ranks


@pytest.mark.cuda
@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_oocore_run_matches_resident_on_the_card(cuda, prog_name):
    """A small out-of-core fused run through the CSR kernel: sssp_bf bit for
    bit and pagerank within tolerance of the resident run, in as many
    iterations, with csr_tile launched (hot set > 0) + uploads times an
    iteration and at most two groups live."""
    g = generate.rmat(4096, 65536, seed=2)
    prog = algorithms.ALGORITHMS[prog_name](g)
    max_it = 10 if prog_name == "pagerank" else None
    want = _oocore_mw(g, prog, cuda).run(max_iterations=max_it)
    mw = _oocore_mw(g, prog, cuda, num_super_shards=4, hot_fraction=0.25)
    before = ebk.csr_tile.launches
    res = mw.run(max_iterations=max_it)
    launched = ebk.csr_tile.launches - before
    assert res.iterations == want.iterations
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(res.state, want.state)
    else:
        np.testing.assert_allclose(res.state, want.state, rtol=1e-5,
                                   atol=1e-6)
    recs = [r["oocore"] for r in res.per_iteration]
    assert launched == sum((r["hot_cols"] > 0) + r["super_shards"]
                           - r["skipped"] for r in recs)
    st = mw.oocore_stats
    assert 1 <= st["max_live_groups"] <= 2
    assert 0.0 <= st["overlap_efficiency"] <= 1.0
    assert st["uploads"] + st["skipped"] == \
        res.iterations * mw.daemon.num_super_shards


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["khop", "sssp", "ppr"])
def test_batched_query_programs_on_the_card(cuda, kind, b, autotune_cache):
    """The serving layer's batched programs at B queries through
    ShardedDaemon(kernel="cuda") on the card (the CSR-tile kernel at K = B:
    add_one/min, add_weight/min, pr_div_deg/sum with aux 1 + B wide), one
    launch an iteration, against run_reference of the same program: min
    programs bit for bit, PPR within rtol 1e-4 / atol 1e-5 (the per-query
    freeze reverts a sub-tolerance apply that the reference keeps).  The
    session over the same daemons answers each column as the loop does."""
    from repro_torch import serve

    g = generate.rmat(256, 2048, seed=9)
    seeds = [3, (5, 9), 17, 17, 40, (1, 2, 3), 200, 7][:b]
    prog = algorithms.BATCHED_QUERIES[kind](g, seeds)
    assert prog.state_width == b and prog.is_batched_query()
    mw = plug.Middleware(
        g, prog, daemon=plug.ShardedDaemon(kernel="cuda", mesh=4,
                                           csr_config=ops.CSRConfig()),
        upper=plug.MeshUpperSystem(mesh=4), num_shards=8,
        options=plug.PlugOptions(block_size=64), device=cuda)
    before = ebk.csr_tile.launches
    res = mw.run()
    assert ebk.csr_tile.launches - before == res.iterations
    ref_state, _ = plug.run_reference(g, prog, device=cuda)
    if kind == "ppr":
        np.testing.assert_allclose(res.state, ref_state, rtol=1e-4,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(res.state, ref_state)
    session = serve.GraphServeSession(
        g, num_shards=8, block_size=64, kernel="cuda", mesh=4,
        csr_config=ops.CSRConfig(), device=cuda)
    answers, rec = session.execute_batch(kind, (), seeds)
    assert rec["bucket"] == b and len(answers) == b
    for q in range(b):
        if kind == "ppr":
            np.testing.assert_allclose(answers[q], res.state[:, q],
                                       rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(answers[q], res.state[:, q])
    assert autotune.CACHE.sweeps == 0


# --------------------------------------------------------------------------
# the model stack through the model kernels
# --------------------------------------------------------------------------
def _model_pair(cuda, arch, dtype):
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model

    cfg = get_reduced(arch).replace(dtype=dtype)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    return model, model.with_kernel("reference")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b",
                                  "zamba2-2.7b", "pixtral-12b"])
def test_model_prefill_through_the_kernels(cuda, arch, dtype):
    """``kernel="cuda"`` launches flash attention once an attention layer
    (invocation) and the SSD chunk kernel once a Mamba2 layer, none in
    decode, and agrees with ``kernel="reference"``: float32 within
    1e-4·max |want| (the kernels' float32 sums), bf16 within 2^-5·max
    |want| (one bf16 ulp in attention carried through the layers)."""
    model, reference = _model_pair(cuda, arch, dtype)
    cfg = model.cfg
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=gen, device=cuda,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = 0.05 * torch.randn(
            (2, cfg.num_patches, cfg.d_model), generator=gen, device=cuda)
    attn_layers = {"dense": cfg.num_layers, "vlm": cfg.num_layers,
                   "ssm": 0, "hybrid": cfg.num_layers // cfg.attn_every}
    ssm_layers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    fa.flash_attention.launches = 0
    ssd.ssd_chunk.launches = 0
    with torch.no_grad():
        logits, cache = model.prefill(batch, cache_len=72)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == attn_layers[cfg.family]
        assert ssd.ssd_chunk.launches == ssm_layers
        want, ref_cache = reference.prefill(batch, cache_len=72)
        assert fa.flash_attention.launches == attn_layers[cfg.family]
    tol = 1e-4 if dtype == "float32" else 2.0 ** -5
    for name, got, ref_ in [("logits", logits, want),
                            *((k, cache[k], ref_cache[k]) for k in cache)]:
        scale = float(ref_.float().abs().max())
        err = float((got.float() - ref_.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
    with torch.no_grad():  # decode (it updates the cache) launches neither
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        model.decode_step(cache, tok, 64)
    assert ssd.ssd_chunk.launches == ssm_layers
    assert fa.flash_attention.launches == attn_layers[cfg.family]


@pytest.mark.cuda
def test_model_kernel_path_never_falls_back(cuda):
    """On the card a kernel the shapes do not fit raises; nothing carries
    on with the plain version."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model

    cfg = get_reduced("mamba2-1.3b")
    with pytest.raises(ValueError, match="ssd_scan.cu"):
        Model(cfg.replace(ssm_head_dim=48), device=cuda)
    x = torch.zeros((1, 16, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        ops.ssd_scan(x, torch.ones((1, 16, 2), device=cuda),
                     -torch.ones(2, device=cuda),
                     torch.zeros((1, 16, 1, 8), device=cuda),
                     torch.zeros((1, 16, 1, 8), device=cuda), chunk=16)


@pytest.mark.cuda
def test_compressed_wire_on_the_card(cuda):
    """``MeshUpperSystem(wire="compressed")`` folds and quantizes on the
    card: pagerank through it within atol 5e-3 of run_reference at m = 1,
    2 and 4, and each merge equal to the CPU's on the same aggregates."""
    from repro_torch.dist import collectives as C

    g = generate.rmat(256, 2048, seed=9)
    prog = algorithms.pagerank(g)
    ref_state, _ = plug.run_reference(g, prog, max_iterations=8,
                                      device="cpu")
    for m in (1, 2, 4):
        upper = plug.MeshUpperSystem(mesh=m, wire="compressed")
        mw = plug.Middleware(g, prog, upper=upper, num_shards=4,
                             options=plug.PlugOptions(block_size=256),
                             device=cuda)
        assert upper.device == cuda
        res = mw.run(max_iterations=8)
        np.testing.assert_allclose(res.state, ref_state, atol=5e-3)
        assert upper._residual.device.type == "cuda"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.pareto(1.5, (4 * 300, 2)).astype(np.float32))
    r = torch.zeros_like(x)
    for bits in (8, 4):
        run = C.make_compressed_allreduce(4, bits=bits)
        got = run(x.to(cuda), r.to(cuda))
        want = run(x, r)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def _plain_grads_of(fn, inputs, grads):
    """Plain autograd of ``fn`` on copies of ``inputs``."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, xs, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq, hkv, s, d", [(4, 4, 200, 64), (8, 2, 128, 80),
                                           (2, 1, 64, 128)])
def test_flash_attention_gradient_is_plain_autograds(cuda, dtype, causal, hq,
                                                     hkv, s, d):
    """Under autograd the kernel launches (once, counted) and its result
    carries a gradient through the ``autograd.Function``; the gradients
    equal plain autograd of ``flash_attention_plain`` on the same inputs
    bit for bit (the backward recomputes exactly that)."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((2, h, s, d), generator=gen, device=cuda)
               .to(dt) for h in (hq, hkv, hkv))
    g = torch.randn((2, hq, s, d), generator=gen, device=cuda).to(dt)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = fa.flash_attention.launches
    out = fa.flash_attention(*xs, causal=causal)
    assert fa.flash_attention.launches == n + 1
    assert out.grad_fn is not None and out.requires_grad
    got = torch.autograd.grad(out, xs, g)
    want = _plain_grads_of(lambda *t: fa.flash_attention_plain(
        *t, causal=causal), (q, k, v), (g,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the forward is the kernel's, not the plain version's
    assert torch.equal(out.detach(), fa.flash_attention(q, k, v,
                                                        causal=causal))
    # a gradient for k alone
    kk = k.clone().requires_grad_(True)
    (gk,) = torch.autograd.grad(fa.flash_attention(q, kk, v, causal=causal),
                                kk, g)
    assert torch.equal(gk, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("l, h, g_", [(256, 8, 1), (64, 4, 4), (17, 6, 2)])
def test_ssd_chunk_gradient_is_plain_autograds(cuda, l, h, g_):
    """The SSD chunk kernel under autograd: one launch, all four outputs
    carry a gradient, and the gradients of every input equal plain
    autograd of ``ssd_chunk_plain`` bit for bit; ``ops.ssd_scan``'s
    cross-chunk loop differentiates on top of it within 1e-4·max of the
    reference path's gradients."""
    gen = torch.Generator(device=cuda).manual_seed(l)
    b, nc, p, n = 2, 3, 64, 16
    x = 0.5 * torch.randn((b, nc, l, h, p), generator=gen, device=cuda)
    dt = torch.exp(torch.empty((b, nc, l, h), device=cuda).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen))
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=cuda))
    bm, cm = (0.3 * torch.randn((b, nc, l, g_, n), generator=gen,
                                device=cuda) for _ in range(2))
    inputs = (x, dt, a, bm, cm)
    outs_g = (torch.randn((b, nc, l, h, p), generator=gen, device=cuda),
              torch.randn((b, nc, h, n, p), generator=gen, device=cuda),
              torch.randn((b, nc, h), generator=gen, device=cuda),
              torch.randn((b, nc, l, h), generator=gen, device=cuda))
    xs = [t.clone().requires_grad_(True) for t in inputs]
    launches = ssd.ssd_chunk.launches
    outs = ssd.ssd_chunk(*xs)
    assert ssd.ssd_chunk.launches == launches + 1
    assert all(o.grad_fn is not None for o in outs)
    got = torch.autograd.grad(outs, xs, outs_g)
    want = _plain_grads_of(ssd.ssd_chunk_plain, inputs, outs_g)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)

    # the whole scan: kernel path against the reference path
    s = nc * l
    flat = (x.reshape(b, s, h, p), dt.reshape(b, s, h), a,
            bm.reshape(b, s, g_, n), cm.reshape(b, s, g_, n))
    gy = torch.randn((b, s, h, p), generator=gen, device=cuda)
    grads = {}
    for impl in ("cuda", "reference"):
        xs = [t.clone().requires_grad_(True) for t in flat]
        y = ops.ssd_scan(*xs, chunk=l, impl=impl)
        assert y.grad_fn is not None
        grads[impl] = torch.autograd.grad(y, xs, gy)
    for got_, want_ in zip(grads["cuda"], grads["reference"]):
        scale = float(want_.abs().max())
        assert float((got_ - want_).abs().max()) <= 1e-4 * max(1.0, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-235b-a22b",
                                  "whisper-base", "stablelm-1.6b"])
def test_model_gradients_through_the_kernels(cuda, arch):
    """``train.step.loss_and_grads`` through ``kernel="cuda"`` (both
    Functions under per-layer rematerialization: each kernel launches twice
    a layer) against ``kernel="reference"`` in float32: the loss within
    1e-5 relative, every gradient leaf within 1e-3·max |want| of that leaf
    (the kernels' float32 sums feed every later layer, and the MoE's
    gather backward adds with atomics)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.train.step import loss_and_grads

    cfg = get_reduced(arch).replace(dtype="float32")
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen,
                           device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = 0.05 * torch.randn(
            (2, cfg.encoder_seq, cfg.d_model), generator=gen, device=cuda)
    fa.flash_attention.launches = ssd.ssd_chunk.launches = 0
    loss, grads = loss_and_grads(model, batch)
    torch.cuda.synchronize()
    attn = {"hybrid": cfg.num_layers // cfg.attn_every, "ssm": 0,
            "encdec": cfg.num_layers + cfg.num_encoder_layers}.get(
        cfg.family, cfg.num_layers)
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    assert fa.flash_attention.launches == 2 * attn
    assert ssd.ssd_chunk.launches == 2 * mamba
    want_loss, want = loss_and_grads(model.with_kernel("reference"), batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for k, w in want.items():
        scale = float(w.abs().max())
        assert float((grads[k] - w).abs().max()) <= 1e-3 * scale + 1e-30, k


def _card_peak(fn):
    """``fn()`` once on the card: its result and the peak allocation
    during the call above what was allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_trace_predicts_the_cards_peak_and_launches(cuda, kind):
    """One zamba2-2.7b (reduced, B=2, S=512) prefill and one AdamW step,
    traced on the meta device under ``op_analysis.OpCounter`` and run on
    the card from the same state: the predicted peak allocation above the
    step's start within 5% of ``max_memory_allocated``'s, and the planned
    launches equal to the wrappers' counts (after a warm-up step, so that
    the card's cuBLAS workspaces exist before either)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import op_analysis
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.serve import make_prefill_step
    from repro_torch.train.step import make_train_step

    cfg = get_reduced("zamba2-2.7b")
    b, s = 2, 512
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = Model(cfg, device=cuda).init(gen)
    twin = Model(cfg, device="meta")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=cuda, dtype=torch.int32)
    if kind == "prefill":
        model.served()
        twin.served()
        card = make_prefill_step(model, cache_len=s)
        meta = make_prefill_step(twin, cache_len=s)
        batch = {"tokens": tokens}

        def run_card():
            return card(batch)

        def run_meta():
            return meta({"tokens": tokens.to("meta")})
    else:
        opt = AdamW(AdamWConfig(peak_lr=1e-4, warmup_steps=1))
        state = [opt.init(model)]
        twin_state = opt.init(twin)
        card = make_train_step(model, opt)
        meta = make_train_step(twin, opt)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        meta_batch = {k: v.to("meta") for k, v in batch.items()}

        def run_card():
            state[0], metrics = card(state[0], batch)
            return metrics

        def run_meta():
            return meta(twin_state, meta_batch)

    run_card()
    fa.flash_attention.launches = ssd.ssd_chunk.launches = 0
    _, measured = _card_peak(run_card)
    counted = {"flash_attention": fa.flash_attention.launches,
               "ssd_chunk": ssd.ssd_chunk.launches}
    with op_analysis.OpCounter() as counter:
        run_meta()
    st = counter.stats()
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == tuple(
        counted.values())
    assert {k: st.kernel_launches.get(k, 0) for k in counted} == counted
    assert counted["flash_attention"] > 0 and counted["ssd_chunk"] > 0
    assert abs(st.peak_bytes / measured - 1.0) <= 0.05, (st.peak_bytes,
                                                         measured)


@pytest.mark.cuda
@pytest.mark.parametrize("execution, kernel", [("vectorized", "csr_tile"),
                                               ("blocked", "edge_block")])
def test_gxengine_shim_runs_the_kernels(cuda, execution, kernel):
    """``GXEngine(use_pallas=True)`` on the card launches the CSR-tile
    kernel (vectorized) or the edge-block kernel (blocked), bit-equal to
    run_reference on sssp_bf."""
    import warnings

    from repro_torch.core.engine import EngineOptions, GXEngine

    g = generate.rmat(2048, 16384, seed=3)
    prog = algorithms.sssp_bf(g)
    counter = getattr(ebk, kernel)
    before = counter.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = GXEngine(g, prog, num_shards=2, options=EngineOptions(
            execution=execution, use_pallas=True, block_size=4096))
    res = eng.run()
    ref_state, _ = plug.run_reference(g, prog)
    np.testing.assert_array_equal(res.state, ref_state)
    assert counter.launches > before
