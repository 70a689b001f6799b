"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
without a CUDA device — the kernels have no CPU mode).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, for every message function × monoid: min/max/or bit-equal, sum
within rtol=1e-5, atol=1e-6 (the kernels add in another order than the
plain version's scatter).  This file imports no JAX, so it runs on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import plug
from repro_torch.core import template
from repro_torch.graph import algorithms, generate
from repro_torch.graph.compaction import build_csr_tiles
from repro_torch.kernels import edge_block as ebk

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
    for daemon in ("cuda", plug.BlockedDaemon(kernel="cuda")):
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
def test_csr_tile_kernel_stages_wide_tiles_beyond_48kb(cuda):
    """ET=1024 at K=16 stages 70 KB of messages per tile, past the 48 KB a
    launch gets without opting in; a tile past the 227 KB limit raises."""
    prog = algorithms.sssp_bf(_graph(), sources=list(range(16)))
    arrs = _tile_inputs(cuda, 29, 16, "min", n=300, e=4000, edge_tile=1024)
    got, got_c = ebk.csr_tile(*arrs, program=prog)
    want, want_c = ebk.csr_tile_plain(*arrs, program=prog)
    torch.cuda.synchronize()
    _assert_match("min", got, want, got_c, want_c)
    big = _tile_inputs(cuda, 31, 16, "min", n=300, e=5000, edge_tile=4096)
    with pytest.raises(ValueError, match="shared memory"):
        ebk.csr_tile(*big, program=prog)
