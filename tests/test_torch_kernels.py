"""The port's two graph kernels against the JAX package's.

On the CPU: the plain PyTorch versions (which the wrappers run on CPU
tensors) against the Pallas kernels in interpret mode, for every message
function × monoid — min/max/or bit-identical, sum within rtol=1e-5,
atol=1e-6 (the JAX kernel sums with a one-hot matrix product, the port with
a segmented scatter, so the order of the float32 additions differs).

The CUDA kernels themselves are held against these plain versions on the
card in tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import template as jtemplate
from repro.graph import algorithms as jalg
from repro.graph import compaction as jcompaction
from repro.graph import generate as jgenerate
from repro.kernels import edge_block as jeb
from repro.kernels import ops as jops
from repro.kernels.autotune import CSRConfig as JCSRConfig
from repro_torch import convert
from repro_torch.core import template as ttemplate
from repro_torch.graph import algorithms as talg
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import ops as tops
from test_torch_cuda import SEAM_DEAD_DST, SEAM_DEGREES, seam_tiles

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6

# gen_op → the program that uses it, and its state width K in these tests
# (sssp_bf and label_prop take K as a parameter; the others are K=1)
GEN_PROGRAMS = {
    "pr_div_deg": ("pagerank", 1),
    "add_weight": ("sssp_bf", 3),
    "mul_weight": ("label_prop", 3),
    "copy_src": ("wcc", 1),
    "add_one": ("bfs", 1),
}
MONOIDS = ("sum", "min", "max", "or")


def _programs(gen_op: str, monoid: str, graph_j, graph_t):
    """The JAX and port programs for ``gen_op`` with ``monoid`` swapped in."""
    name, k = GEN_PROGRAMS[gen_op]
    kw = {"sssp_bf": {"sources": list(range(k))},
          "label_prop": {"num_classes": k}}.get(name, {})
    pj = getattr(jalg, name)(graph_j, **kw)
    pt = getattr(talg, name)(graph_t, **kw)
    assert pt.gen_op == gen_op and pt.state_width == k
    return (dataclasses.replace(pj, monoid=jtemplate.MONOIDS[monoid]),
            dataclasses.replace(pt, monoid=ttemplate.MONOIDS[monoid]))


def _graphs():
    gj = jgenerate.rmat(96, 700, seed=5)
    return gj, convert.graph_from_arrays(gj.src, gj.dst, gj.weights,
                                         gj.num_vertices)


def _values(rng, shape, monoid):
    if monoid == "or":  # {0, 1} indicators
        return (rng.random(shape) < 0.5).astype(np.float32)
    return rng.uniform(0.0, 10.0, shape).astype(np.float32)


def _block_inputs(seed, k, monoid, nb=3, vb=40, b=64, a=1):
    rng = np.random.default_rng(seed)
    return (_values(rng, (nb, vb, k), monoid),
            rng.uniform(0.0, 5.0, (nb, vb, a)).astype(np.float32),
            rng.integers(0, vb, (nb, b)).astype(np.int32),
            rng.integers(0, vb, (nb, b)).astype(np.int32),
            rng.uniform(1.0, 10.0, (nb, b, 1)).astype(np.float32),
            (rng.random((nb, b)) < 0.8).astype(np.float32))


def _tile_inputs(seed, k, monoid, n=80, e=600, edge_tile=32):
    """Real compacted tiles (a hub row split across tiles included) with a
    random frontier mask over their live edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.concatenate([np.zeros(e // 6, np.int32),   # hub row 0
                          rng.integers(0, n, e - e // 6).astype(np.int32)])
    w = rng.uniform(1.0, 10.0, e).astype(np.float32)
    ts = jcompaction.build_csr_tiles(src, dst, w, n, edge_tile=edge_tile)
    state = _values(rng, (n, k), monoid)
    aux = rng.uniform(0.0, 5.0, (n, 1)).astype(np.float32)
    emask = ts.emask & (rng.random(ts.emask.shape) < 0.8)
    return (state[ts.svids], aux[ts.svids], state[ts.rows], ts.lsrc, ts.seg,
            ts.w, emask.astype(np.float32))


def _assert_match(monoid, got, want, got_c, want_c):
    np.testing.assert_array_equal(got_c, want_c)
    if monoid == "sum":
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("gen_op", sorted(GEN_PROGRAMS))
def test_edge_block_plain_matches_pallas(gen_op, monoid):
    pj, pt = _programs(gen_op, monoid, *_graphs())
    arrs = _block_inputs(11, GEN_PROGRAMS[gen_op][1], monoid)
    want, want_c = jeb.edge_block_pallas(*map(jnp.asarray, arrs), program=pj,
                                         interpret=True)
    got, got_c = teb.edge_block(*map(torch.from_numpy, arrs), program=pt)
    _assert_match(monoid, got.numpy(), np.asarray(want), got_c.numpy(),
                  np.asarray(want_c))


@pytest.mark.parametrize("gather", ["take", "onehot"])
@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("gen_op", sorted(GEN_PROGRAMS))
def test_csr_tile_plain_matches_pallas(gen_op, monoid, gather):
    pj, pt = _programs(gen_op, monoid, *_graphs())
    arrs = _tile_inputs(13, GEN_PROGRAMS[gen_op][1], monoid)
    want, want_c = jeb.csr_tile_pallas(*map(jnp.asarray, arrs), program=pj,
                                       gather=gather, interpret=True)
    got, got_c = teb.csr_tile(*map(torch.from_numpy, arrs), program=pt)
    _assert_match(monoid, got.numpy(), np.asarray(want), got_c.numpy(),
                  np.asarray(want_c))


def _csr_case(prog_name, graph_j, graph_t):
    pj = getattr(jalg, prog_name)(graph_j)
    pt = getattr(talg, prog_name)(graph_t)
    rng = np.random.default_rng(3)
    n = graph_j.num_vertices
    state = rng.uniform(0.0, 10.0, (n, pt.state_width)).astype(np.float32)
    aux = np.asarray(pt.init(graph_t)[1])
    ts = jcompaction.build_csr_tiles(graph_j.src, graph_j.dst,
                                     graph_j.weights, n, edge_tile=64)
    csr = ts.arrays()
    csr["emask"] = csr["emask"] & (rng.random(csr["emask"].shape) < 0.7)
    return pj, pt, state, aux, csr


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp_bf", "label_prop"])
@pytest.mark.parametrize("jcfg", [
    JCSRConfig(edge_tile=64, lowering="xla", merge="sorted"),
    JCSRConfig(edge_tile=64, lowering="xla", merge="onehot", gather="onehot"),
    JCSRConfig(edge_tile=64, lowering="pallas", merge="sorted"),
    JCSRConfig(edge_tile=64, merge="flat"),
], ids=lambda c: c.label)
def test_csr_aggregate_matches_jax(prog_name, jcfg):
    """The port's one CSR aggregation against each of the JAX package's
    lowerings (all of which compute the same aggregate)."""
    gj, gt = _graphs()
    pj, pt, state, aux, csr = _csr_case(prog_name, gj, gt)
    want, want_c = jops.csr_aggregate(
        jnp.asarray(state), jnp.asarray(aux),
        {k: jnp.asarray(v) for k, v in csr.items()}, program=pj,
        num_vertices=gj.num_vertices, config=jcfg)
    got, got_c = tops.csr_aggregate(
        torch.from_numpy(state), torch.from_numpy(aux),
        {k: torch.from_numpy(v) for k, v in csr.items()}, program=pt,
        num_vertices=gt.num_vertices, config=tops.CSRConfig(edge_tile=64))
    _assert_match(pt.monoid.name, got.numpy(), np.asarray(want),
                  got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp_bf", "wcc"])
def test_edge_block_aggregate_matches_jax(prog_name):
    from repro.core.blocks import build_blocks
    from repro.graph.partition import partition_contiguous

    gj, gt = _graphs()
    pj = getattr(jalg, prog_name)(gj)
    pt = getattr(talg, prog_name)(gt)
    bs = build_blocks(partition_contiguous(gj, 1)[0], 128)
    state, aux = pj.init(gj)
    state = np.random.default_rng(4).uniform(
        0.0, 10.0, state.shape).astype(np.float32)
    arrs = (bs.vids, bs.lsrc, bs.ldst, bs.weights, bs.emask)
    want, want_c = jops.edge_block_aggregate(
        jnp.asarray(state), jnp.asarray(aux), *map(jnp.asarray, arrs),
        program=pj, impl="pallas")
    for impl in ("cuda", "reference"):
        got, got_c = tops.edge_block_aggregate(
            torch.from_numpy(state), torch.from_numpy(aux),
            *map(torch.from_numpy, arrs), program=pt, impl=impl)
        _assert_match(pt.monoid.name, got.numpy(), np.asarray(want),
                      got_c.numpy(), np.asarray(want_c))


def test_unknown_monoid_raises_in_both_packages():
    gj, gt = _graphs()
    pj = dataclasses.replace(
        jalg.wcc(gj), monoid=jtemplate.Monoid("xor", 0.0, jnp.maximum,
                                              idempotent=False))
    pt = dataclasses.replace(
        talg.wcc(gt), monoid=ttemplate.Monoid("xor", 0.0, torch.maximum,
                                              idempotent=False))
    barrs = _block_inputs(1, 1, "min")
    tarrs = _tile_inputs(2, 1, "min")
    with pytest.raises(ValueError, match="xor"):
        jeb.edge_block_pallas(*map(jnp.asarray, barrs), program=pj)
    with pytest.raises(ValueError, match="xor"):
        jeb.csr_tile_pallas(*map(jnp.asarray, tarrs), program=pj)
    with pytest.raises(ValueError, match="xor"):
        teb.edge_block(*map(torch.from_numpy, barrs), program=pt)
    with pytest.raises(ValueError, match="xor"):
        teb.csr_tile(*map(torch.from_numpy, tarrs), program=pt)
    with pytest.raises(ValueError, match="xor"):
        pt.monoid.scatter_at(torch.zeros(4, 1), [0], torch.ones(1, 1))


# The message functions as csrc/common.cuh computes them.
KERNEL_GEN = {
    "pr_div_deg": lambda s, w, a0: s / torch.clamp(a0, min=1.0),
    "add_weight": lambda s, w, a0: s + w,
    "mul_weight": lambda s, w, a0: s * w,
    "copy_src": lambda s, w, a0: s,
    "add_one": lambda s, w, a0: s + 1.0,
}


@pytest.mark.parametrize("gen_op", sorted(GEN_PROGRAMS))
def test_gen_op_matches_program_msg_gen(gen_op):
    """Each program's gen_op names the function its torch msg_gen computes,
    so the kernels and the plain path generate the same messages."""
    _, pt = _programs(gen_op, "sum", *_graphs())
    rng = np.random.default_rng(7)
    e, k = 50, GEN_PROGRAMS[gen_op][1]
    s = torch.from_numpy(rng.uniform(0, 10, (e, k)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 10, (e, 1)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0, 5, (e, 1)).astype(np.float32))
    want = pt.msg_gen(s, s.flip(0), w, a)
    got = KERNEL_GEN[gen_op](s, w, a[:, :1])
    assert torch.equal(got, want)


def test_program_without_gen_op_raises_on_cuda_path_only():
    gj, gt = _graphs()
    pt = dataclasses.replace(talg.wcc(gt), gen_op=None)
    arrs = [torch.from_numpy(a) for a in _block_inputs(3, 1, "min")]
    partial, _ = teb.edge_block(*arrs, program=pt)  # CPU: plain path
    assert partial.shape == (3, 40, 1)
    with pytest.raises(ValueError, match="gen_op"):
        teb._gen_op(pt)


# --------------------------------------------------------------------------
# CSR tiles at the seams of a warp-cooperative segmented reduce
# --------------------------------------------------------------------------
# Layouts at the seams of the CUDA kernel's warp-cooperative segmented
# reduce (tests/test_torch_cuda.py builds them; no card is needed for that)
# K → the program whose message function the case runs
SEAM_PROGRAMS = {1: "pagerank", 3: "label_prop", 4: "sssp_bf",
                 8: "label_prop", 16: "sssp_bf"}


def test_seam_tiles_cover_the_seams():
    ts, arrs = seam_tiles(0, 1, "sum")
    assert ts.edge_tile == 512 and ts.num_tiles >= 6
    hub = SEAM_DEGREES.index(700) * 7 + 3
    assert (ts.gdst == hub).any(axis=1).sum() == 2      # split hub row
    assert (~ts.emask).any(axis=1).sum() >= 3           # padded tiles
    assert ts.emask.all(axis=1).sum() >= 1              # a full 512 run
    assert not arrs[-1][ts.gdst == SEAM_DEAD_DST].any()


@pytest.mark.parametrize("monoid", MONOIDS)
@pytest.mark.parametrize("k", sorted(SEAM_PROGRAMS))
def test_csr_tile_seams_match_pallas(k, monoid):
    gj, gt = _graphs()
    name = SEAM_PROGRAMS[k]
    kw = {"sssp_bf": {"sources": list(range(k))},
          "label_prop": {"num_classes": k}}.get(name, {})
    pj = dataclasses.replace(getattr(jalg, name)(gj, **kw),
                             monoid=jtemplate.MONOIDS[monoid])
    pt = dataclasses.replace(getattr(talg, name)(gt, **kw),
                             monoid=ttemplate.MONOIDS[monoid])
    assert pt.state_width == k
    _, arrs = seam_tiles(k, k, monoid)
    want, want_c = jeb.csr_tile_pallas(*map(jnp.asarray, arrs), program=pj,
                                       interpret=True)
    got, got_c = teb.csr_tile(*map(torch.from_numpy, arrs), program=pt)
    _assert_match(monoid, got.numpy(), np.asarray(want), got_c.numpy(),
                  np.asarray(want_c))
