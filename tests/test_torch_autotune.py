"""The port's CSR autotuning (``kernels/autotune.py``) and the lowerings it
chooses among (``kernels/ops.py::csr_aggregate``) against the JAX
package's, on the CPU.

* Every point of the port's CPU space and of its card space computes, on
  CPU tensors, the aggregate that the JAX package's ``csr_aggregate``
  computes at the counterpart config (Pallas in interpret mode), on the
  same tiles: min/max/or bit for bit, sum within rtol=1e-5, atol=1e-6.
* The memo answers an identical second call and sweeps again for another
  |E|; its report has the JAX package's keys.
* The daemons resolve their config as the JAX package's do: once per
  binding (``VectorizedDaemon``), on the shard with the most live edges
  (``ShardedDaemon``).  Their winners come from ``AutotuneCache.store``,
  never from the clock, and a fixture clears the process-wide ``CACHE``
  around every test.
* The fused loop at an explicit flat config equals the JAX package's fused
  loop at the same config.
* A program without a ``gen_op`` whose ``msg_gen`` reads the dst rows gets
  the real rows through the flat merge and the tiled plain twin, sweeps
  only the points that launch no kernel, and has a memo key of its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import plug as jplug
from repro.graph import algorithms as jalg
from repro.graph import compaction as jcompaction
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro_torch import plug as tplug
from repro_torch.graph import algorithms as talg
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels.autotune import CSRConfig
from test_torch_fused import (BLOCK, PROGRAMS, RECORD_KEYS, _assert_same_run,
                              _graph, _max_it, jax_config)
from test_torch_kernels import (GEN_PROGRAMS, _assert_match, _graphs,
                                _programs, _values)

# (gen_op, monoid) cases: each monoid once, K=1 and K=3 both
CASES = [("pr_div_deg", "sum"), ("mul_weight", "sum"), ("add_weight", "min"),
         ("mul_weight", "max"), ("copy_src", "or")]
# every point the port sweeps, on the CPU or on the card, once
SPACE = tuple({c.label: c for c in
               autotune.CPU_SPACE + autotune.CUDA_SPACE}.values())
FLAT = CSRConfig(edge_tile=256, lowering="torch", merge="flat")


@pytest.fixture(autouse=True)
def clear_cache():
    autotune.CACHE.clear()
    yield
    autotune.CACHE.clear()


def _edges(seed, n=120, e=2600):
    """An edge list with a hub row (split across tiles at every edge tile
    swept) and random weights."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.concatenate([np.zeros(e // 2, np.int32),
                          rng.integers(0, n, e - e // 2).astype(np.int32)])
    w = rng.uniform(1.0, 10.0, e).astype(np.float32)
    return src, dst, w, n


def test_spaces_are_the_jax_space_and_the_card_points():
    """The CPU space is the JAX package's DEFAULT_SPACE point for point
    (lowering renamed); the card space is the flat merge at three edge
    tiles and the kernel at two."""
    assert [jax_config(c) for c in autotune.CPU_SPACE] == \
        list(jautotune.DEFAULT_SPACE)
    assert [c.label for c in autotune.CUDA_SPACE] == [
        "torch/flat/take/et256", "torch/flat/take/et512",
        "torch/flat/take/et1024", "cuda/sorted/take/et256",
        "cuda/sorted/take/et512"]
    assert autotune.default_space("cpu") == autotune.CPU_SPACE
    assert CSRConfig().label == "cuda/sorted/take/et512"
    assert tops.CSRConfig is CSRConfig


@pytest.mark.parametrize("gen_op, monoid", CASES)
@pytest.mark.parametrize("config", SPACE, ids=lambda c: c.label)
def test_every_space_point_matches_jax(config, gen_op, monoid):
    src, dst, w, n = _edges(21)
    pj, pt = _programs(gen_op, monoid, *_graphs())
    k = GEN_PROGRAMS[gen_op][1]
    rng = np.random.default_rng(5)
    state = _values(rng, (n, k), monoid)
    aux = rng.uniform(0.0, 5.0, (n, 1)).astype(np.float32)
    ts = jcompaction.build_csr_tiles(src, dst, w, n,
                                     edge_tile=config.edge_tile)
    csr = ts.arrays()
    csr["emask"] = csr["emask"] & (rng.random(csr["emask"].shape) < 0.8)
    want, want_c = jops.csr_aggregate(
        jnp.asarray(state), jnp.asarray(aux),
        {f: jnp.asarray(v) for f, v in csr.items()}, program=pj,
        num_vertices=n, config=jax_config(config), interpret=True)
    got, got_c = tops.csr_aggregate(
        torch.from_numpy(state), torch.from_numpy(aux),
        {f: torch.from_numpy(v) for f, v in csr.items()}, program=pt,
        num_vertices=n, config=config)
    _assert_match(monoid, got.numpy(), np.asarray(want), got_c.numpy(),
                  np.asarray(want_c))


def test_lowering_torch_and_unknown_names_are_refused_off_the_cpu():
    """The tiled plain twin serves CPU tensors only: on any other device it
    raises instead of standing in for the kernel."""
    src, dst, w, n = _edges(3)
    pt = talg.sssp_bf(_graphs()[1], sources=[0, 1, 2])
    csr = {f: torch.from_numpy(v).to("meta") for f, v in
           jcompaction.build_csr_tiles(src, dst, w, n).arrays().items()}
    state = torch.zeros(n, 3, device="meta")
    for merge in ("sorted", "onehot"):
        with pytest.raises(ValueError, match="CPU tensors only"):
            tops.csr_aggregate(state, torch.zeros(n, 0, device="meta"), csr,
                               program=pt, num_vertices=n,
                               config=CSRConfig(lowering="torch",
                                                merge=merge))


def test_memo_answers_the_second_call():
    """An identical second call is a lookup (hits 1, sweeps 1) returning
    the same config; another |E| sweeps again; the table holds every
    point of the space."""
    src, dst, w, n = _edges(4, e=900)
    pt = talg.sssp_bf(_graphs()[1], sources=[0, 1, 2])
    cache = autotune.CACHE
    cfg1 = autotune.autotune_csr(src, dst, w, n, pt, repeats=1, device="cpu")
    assert (cache.sweeps, cache.hits) == (1, 0)
    cfg2 = autotune.autotune_csr(src, dst, w, n, pt, repeats=1, device="cpu")
    assert (cache.sweeps, cache.hits) == (1, 1)
    assert cfg1 is cfg2 and cfg1 in autotune.CPU_SPACE
    autotune.autotune_csr(src[:700], dst[:700], w[:700], n, pt, repeats=1,
                          device="cpu")
    assert (cache.sweeps, cache.hits) == (2, 1)
    for entry in cache.report()["entries"]:
        assert set(entry["table"]) == {c.label for c in autotune.CPU_SPACE}
        assert all(t > 0 for t in entry["table"].values())


def test_an_explicit_one_point_space_is_its_winner():
    src, dst, w, n = _edges(4, e=900)
    pt = talg.pagerank(_graphs()[1])
    got = autotune.autotune_csr(src, dst, None, n, pt, space=(FLAT,),
                                repeats=1, device="cpu")
    assert got is FLAT
    (entry,) = autotune.CACHE.report()["entries"]
    assert entry["chosen"] == FLAT.label and entry["num_edges"] == 900


def test_report_has_the_jax_keys():
    """The same entry stored in both packages' memos reports the same keys
    and values, the backend and the table's labels aside."""
    gj, gt = _graphs()
    pj, pt = jalg.sssp_bf(gj), talg.sssp_bf(gt)
    jcache = jautotune.AutotuneCache()
    jcache.store(jautotune.signature(96, 700, pj, jautotune.DEFAULT_SPACE),
                 {"config": jax_config(FLAT), "table": {"t": 1.0}})
    autotune.CACHE.store(
        autotune.signature(96, 700, pt, autotune.CPU_SPACE, "cpu"),
        {"config": FLAT, "table": {"t": 1.0}})
    want, got = jcache.report(), autotune.CACHE.report()
    assert set(got) == set(want)
    (we,), (ge,) = want["entries"], got["entries"]
    assert set(ge) == set(we)
    for key in ("num_vertices", "num_edges", "state_width", "aux_width",
                "monoid", "table"):
        assert ge[key] == we[key], key
    assert ge["backend"] == "cpu"
    assert ge["chosen"] == "torch/flat/take/et256"
    assert we["chosen"] == "xla/flat/take/et256"


def _host_mw(daemon, shards=2, **kw):
    _, gt = _graph("sssp_bf")
    return tplug.Middleware(gt, talg.sssp_bf(gt), daemon=daemon,
                            num_shards=shards,
                            options=tplug.PlugOptions(block_size=BLOCK),
                            device="cpu", **kw)


def _store_winner(blockset, program, n, config, space=autotune.CPU_SPACE):
    live = int(blockset.emask.sum())
    autotune.CACHE.store(autotune.signature(n, live, program, space, "cpu"),
                         {"config": config, "table": {config.label: 1.0}})


def test_vectorized_daemon_resolves_once_per_binding():
    daemon = tplug.VectorizedDaemon(kernel="cuda")
    mw = _host_mw(daemon)
    _store_winner(mw.blocksets[0], mw.program, mw.n, FLAT)
    res = mw.run()
    # one lookup for the binding: shard 1 reuses shard 0's choice
    assert daemon._csr_config is FLAT
    assert (autotune.CACHE.sweeps, autotune.CACHE.hits) == (1, 1)
    mw.run()
    assert autotune.CACHE.hits == 1
    daemon.bind(mw.program, mw.n, device="cpu")  # a rebind resets it
    assert daemon._csr_config is None
    again = mw.run()
    assert autotune.CACHE.hits == 2 and daemon._csr_config is FLAT
    pinned = _host_mw(tplug.VectorizedDaemon(
        kernel="cuda", csr_config=CSRConfig())).run()
    for r in (res, again):
        np.testing.assert_array_equal(r.state, pinned.state)
        assert r.iterations == pinned.iterations


def test_an_explicit_config_survives_a_rebind():
    daemon = tplug.VectorizedDaemon(kernel="cuda", csr_config=FLAT)
    mw = _host_mw(daemon)
    mw.run()
    daemon.bind(mw.program, mw.n, device="cpu")
    mw.run()
    assert daemon._csr_config is FLAT
    assert (autotune.CACHE.sweeps, autotune.CACHE.hits) == (0, 0)


def test_sharded_daemon_tunes_on_the_largest_shard():
    """The sharded daemon looks up the signature of the shard with the
    most live edges and pins the winner, stacking gdst for the flat
    merge; its fused loop then equals the pinned kernel's."""
    _, gt = _graph("sssp_bf")
    kw = dict(upper="mesh", num_shards=3, capacities=(1.0, 2.0, 4.0),
              options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    prog = talg.sssp_bf(gt)
    pinned = tplug.Middleware(gt, prog, daemon=tplug.ShardedDaemon(
        kernel="cuda", csr_config=CSRConfig()), **kw)
    live = [int(bs.emask.sum()) for bs in pinned.blocksets]
    assert len(set(live)) == 3
    big = pinned.blocksets[int(np.argmax(live))]
    _store_winner(big, prog, gt.num_vertices, FLAT)
    tuned = tplug.Middleware(gt, prog, daemon=tplug.ShardedDaemon(
        kernel="cuda"), **kw)
    assert tuned.daemon._csr_config is FLAT
    assert (autotune.CACHE.sweeps, autotune.CACHE.hits) == (1, 1)
    assert "gdst" in tuned.daemon.stacked["csr"]
    assert "gdst" not in pinned.daemon.stacked["csr"]
    got, want = tuned.run(), pinned.run()
    np.testing.assert_array_equal(got.state, want.state)
    assert got.iterations == want.iterations
    assert autotune.CACHE.hits == 1  # the run looks nothing up


@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_fused_loop_at_the_flat_config_matches_jax(prog_name):
    gj, gt = _graph(prog_name)
    jd = jplug.get_daemon("sharded", kernel="pallas",
                          csr_config=jax_config(FLAT))
    want = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj), daemon=jd,
                            upper="mesh", num_shards=4,
                            options=jplug.PlugOptions(block_size=BLOCK)
                            ).run(max_iterations=_max_it(prog_name))
    mw = tplug.Middleware(gt, talg.ALGORITHMS[prog_name](gt),
                          daemon=tplug.ShardedDaemon(kernel="cuda",
                                                     csr_config=FLAT),
                          upper="mesh", num_shards=4,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    res = mw.run(max_iterations=_max_it(prog_name))
    assert isinstance(mw._loop, tplug.DriveLoop)
    _assert_same_run(prog_name, res, want)
    for key in RECORD_KEYS:
        assert [r[key] for r in res.per_iteration] == \
            [r[key] for r in want.per_iteration], key


# --------------------------------------------------------------------------
# a program without a gen_op: real dst rows, its own sweep and memo key
# --------------------------------------------------------------------------
def _dst_min(gj, gt):
    """sssp_bf with ``msg_gen = min(s + w, d + 1)``: it reads the dst rows
    and names no ``gen_op``, so no kernel can run it.  ``d + 1`` never
    undercuts ``d``, so its fixed point is sssp_bf's; a dst row read as 0
    would cap every message at 1."""
    pj = dataclasses.replace(
        jalg.sssp_bf(gj), name="dst_min",
        msg_gen=lambda s, d, w, a: jnp.minimum(s + w, d + 1.0))
    pt = dataclasses.replace(
        talg.sssp_bf(gt), name="dst_min", gen_op=None,
        msg_gen=lambda s, d, w, a: torch.minimum(s + w, d + 1.0))
    return pj, pt


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("config", [
    FLAT, CSRConfig(edge_tile=256, lowering="torch", merge="sorted")],
    ids=lambda c: c.label)
def test_program_without_gen_op_reads_real_dst_rows(config, groups):
    """``csr_aggregate_groups`` hands such a program ``state[gdst]`` (flat)
    and ``state[rows]`` (tiled), as the JAX package does: each group's
    aggregate equals JAX's ``csr_aggregate`` over that group's tiles."""
    src, dst, w, n = _edges(8)
    pj, pt = _dst_min(*_graphs())
    rng = np.random.default_rng(2)
    state = rng.uniform(0.0, 20.0, (n, 4)).astype(np.float32)
    aux = np.zeros((n, 0), np.float32)
    csr = jcompaction.build_csr_tiles(src, dst, w, n,
                                      edge_tile=config.edge_tile).arrays()
    t = csr["emask"].shape[0] // groups * groups
    csr = {f: v[:t] for f, v in csr.items()}
    got, got_c = tops.csr_aggregate_groups(
        torch.from_numpy(state), torch.from_numpy(aux),
        {f: torch.from_numpy(v) for f, v in csr.items()}, program=pt,
        num_vertices=n, config=config, groups=groups)
    for g in range(groups):
        part = {f: jnp.asarray(v[g * t // groups:(g + 1) * t // groups])
                for f, v in csr.items()}
        want, want_c = jops.csr_aggregate(
            jnp.asarray(state), jnp.asarray(aux), part, program=pj,
            num_vertices=n, config=jax_config(config), interpret=True)
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_c[g].numpy(), np.asarray(want_c))


def test_program_without_gen_op_sweeps_only_kernel_free_points():
    """The sweep times only the ``lowering="torch"`` points for such a
    program, and its memo entry is its own: sssp_bf, of the same shape,
    sweeps again instead of taking its winner."""
    src, dst, w, n = _edges(4, e=900)
    _, pt = _dst_min(*_graphs())
    autotune.autotune_csr(src, dst, w, n, pt, repeats=1, device="cpu")
    (entry,) = autotune.CACHE.report()["entries"]
    assert set(entry["table"]) == {c.label for c in autotune.CPU_SPACE
                                   if c.lowering == "torch"}
    assert autotune.runnable_space(autotune.CUDA_SPACE, pt) == \
        autotune.CUDA_SPACE[:3]
    sssp = talg.sssp_bf(_graphs()[1])
    assert autotune.runnable_space(autotune.CUDA_SPACE, sssp) == \
        autotune.CUDA_SPACE
    autotune.autotune_csr(src, dst, w, n, sssp, repeats=1, device="cpu")
    assert (autotune.CACHE.sweeps, autotune.CACHE.hits) == (2, 0)
    assert autotune.signature(n, 900, pt, autotune.CPU_SPACE, "cpu") != \
        autotune.signature(n, 900, sssp, autotune.CPU_SPACE, "cpu")
    with pytest.raises(ValueError, match="lowering='torch'"):
        autotune.autotune_csr(src, dst, w, n, pt, space=(CSRConfig(),),
                              device="cpu")


@pytest.mark.parametrize("csr_config", [None, FLAT], ids=["swept", "flat"])
def test_fused_loop_runs_a_dst_reading_program_exactly(csr_config):
    """The fused loop (swept, or pinned to the flat merge) runs the
    dst-reading program to ``run_reference``'s fixed point and to the JAX
    package's fused loop at the flat config, bit for bit."""
    gj, gt = _graph("sssp_bf")
    pj, pt = _dst_min(gj, gt)
    mw = tplug.Middleware(gt, pt, daemon=tplug.ShardedDaemon(
        kernel="cuda", csr_config=csr_config), upper="mesh", num_shards=4,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    assert mw.daemon._csr_config.lowering == "torch"
    res = mw.run()
    want = jplug.Middleware(
        gj, pj, daemon=jplug.get_daemon("sharded", kernel="pallas",
                                        csr_config=jax_config(FLAT)),
        upper="mesh", num_shards=4,
        options=jplug.PlugOptions(block_size=BLOCK)).run()
    ref, ref_it = tplug.run_reference(gt, pt, device="cpu")
    assert res.converged and res.iterations == want.iterations
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    np.testing.assert_array_equal(res.state, ref)
    sssp, _ = tplug.run_reference(gt, talg.sssp_bf(gt), device="cpu")
    np.testing.assert_array_equal(res.state, sssp)
