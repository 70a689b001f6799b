"""The port's host-side modules (copies of the JAX package's NumPy modules)
give results byte-identical to the JAX package's on the same inputs."""
import numpy as np
import pytest

from repro.core import balance as jbalance
from repro.core import blocks as jblocks
from repro.core import pipeline as jpipeline
from repro.core import pow2 as jpow2
from repro.core import sync as jsync
from repro.graph import compaction as jcompaction
from repro.graph import generate as jgenerate
from repro.graph import partition as jpartition
from repro_torch import convert
from repro_torch.core import balance as tbalance
from repro_torch.core import blocks as tblocks
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import pow2 as tpow2
from repro_torch.core import sync as tsync
from repro_torch.graph import compaction as tcompaction
from repro_torch.graph import generate as tgenerate
from repro_torch.graph import partition as tpartition


def _port(g):
    return convert.graph_from_arrays(g.src, g.dst, g.weights, g.num_vertices)


def _same_graph(a, b):
    assert a.num_vertices == b.num_vertices
    for f in ("src", "dst", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name, args, kw", [
    ("rmat", (512, 4096), {"seed": 7}),
    ("rmat", (300, 2000), {"seed": 1, "weighted": False}),
    ("uniform", (512, 4096), {"seed": 11}),
    ("clustered", (600, 6000), {"num_clusters": 4, "p_cross": 0.03,
                                "seed": 3}),
    ("grid_road", (12,), {"seed": 2}),
    ("rmat_stream", (1 << 10, 600_000), {"seed": 5}),
])
def test_generators_match(name, args, kw):
    _same_graph(getattr(jgenerate, name)(*args, **kw),
                getattr(tgenerate, name)(*args, **kw))


def test_graph_from_arrays_roundtrip(rmat_graph):
    g = _port(rmat_graph)
    _same_graph(rmat_graph, g)
    np.testing.assert_array_equal(g.out_degrees(), rmat_graph.out_degrees())
    _same_graph(rmat_graph.with_reverse_edges(), g.with_reverse_edges())


GRAPHS = ["rmat_graph", "clustered_graph", "uniform_graph"]


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_partition_contiguous_byte_identical(graph, shards, request):
    gj = request.getfixturevalue(graph)
    pj = jpartition.partition_contiguous(gj, shards)
    pt = tpartition.partition_contiguous(_port(gj), shards)
    assert len(pj) == len(pt)
    for a, b in zip(pj, pt):
        assert a.shard_id == b.shard_id
        for f in ("src", "dst", "weights", "boundary_mask"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()


def test_partition_fractions_and_hash_byte_identical(rmat_graph):
    fr = jbalance.lemma2_fractions(np.array([1.0, 2.0, 4.0]))
    np.testing.assert_array_equal(
        fr, tbalance.lemma2_fractions(np.array([1.0, 2.0, 4.0])))
    for pj, pt in ((jpartition.partition_contiguous(rmat_graph, 3, fr),
                    tpartition.partition_contiguous(_port(rmat_graph), 3,
                                                    fr)),
                   (jpartition.partition_hash(rmat_graph, 4),
                    tpartition.partition_hash(_port(rmat_graph), 4))):
        for a, b in zip(pj, pt):
            assert a.src.tobytes() == b.src.tobytes()
            assert a.boundary_mask.tobytes() == b.boundary_mask.tobytes()


_BLOCK_FIELDS = ("vids", "vmask", "lsrc", "ldst", "weights", "emask", "gsrc",
                 "gdst")


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("block_size", [64, 256, 1000])
def test_build_blocks_byte_identical(graph, block_size, request):
    gj = request.getfixturevalue(graph)
    pj = jpartition.partition_contiguous(gj, 2)
    pt = tpartition.partition_contiguous(_port(gj), 2)
    for a, b in zip(pj, pt):
        bj = jblocks.build_blocks(a, block_size)
        bt = tblocks.build_blocks(b, block_size)
        assert (bj.block_size, bj.vblock_size, bj.num_blocks, bj.num_edges) \
            == (bt.block_size, bt.vblock_size, bt.num_blocks, bt.num_edges)
        for f in _BLOCK_FIELDS:
            assert getattr(bj, f).tobytes() == getattr(bt, f).tobytes(), f


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("edge_tile, hub", [(32, None), (512, None),
                                            (64, 16)])
def test_tiles_from_blockset_byte_identical(graph, edge_tile, hub, request):
    gj = request.getfixturevalue(graph)
    bj = jblocks.build_blocks(jpartition.partition_contiguous(gj, 1)[0], 256)
    bt = tblocks.build_blocks(
        tpartition.partition_contiguous(_port(gj), 1)[0], 256)
    tj = jcompaction.tiles_from_blockset(bj, gj.num_vertices,
                                         edge_tile=edge_tile,
                                         hub_threshold=hub)
    tt = tcompaction.tiles_from_blockset(bt, gj.num_vertices,
                                         edge_tile=edge_tile,
                                         hub_threshold=hub)
    assert (tj.edge_tile, tj.row_tile, tj.src_tile, tj.num_tiles) \
        == (tt.edge_tile, tt.row_tile, tt.src_tile, tt.num_tiles)
    aj, at = tj.arrays(), tt.arrays()
    assert aj.keys() == at.keys()
    for k in aj:
        assert aj[k].dtype == at[k].dtype and aj[k].tobytes() == at[k].tobytes()
    assert tj.eblock.tobytes() == tt.eblock.tobytes()
    np.testing.assert_array_equal(tj.hub_rows(), tt.hub_rows())


def test_lru_cache_and_exchange_plan_agree_on_a_script():
    rng = np.random.default_rng(0)
    cj, ct = jsync.LRUVertexCache(24), tsync.LRUVertexCache(24)
    for step in range(30):
        cj.tick()
        ct.tick()
        ids = np.unique(rng.integers(0, 80, rng.integers(0, 20)))
        np.testing.assert_array_equal(cj.lookup(ids), ct.lookup(ids))
        fresh = np.unique(rng.integers(0, 80, 6))
        cj.insert(fresh)
        ct.insert(fresh)
        if step % 4 == 3:
            gone = rng.integers(0, 80, 5)
            cj.invalidate(gone)
            ct.invalidate(gone)
        np.testing.assert_array_equal(cj._ids, ct._ids)
        np.testing.assert_array_equal(cj._weights, ct._weights)
        upd = [np.unique(rng.integers(0, 80, 7)) for _ in range(3)]
        qry = [np.unique(rng.integers(0, 80, 9)) for _ in range(3)]
        (gj, uj), (gt, ut) = (jsync.lazy_exchange_plan(upd, qry),
                              tsync.lazy_exchange_plan(upd, qry))
        np.testing.assert_array_equal(gj, gt)
        for a, b in zip(uj, ut):
            np.testing.assert_array_equal(a, b)
        masks = [rng.random(80) < 0.3 for _ in range(3)]
        assert jsync.can_skip_sync(upd, masks) == tsync.can_skip_sync(upd,
                                                                      masks)


@pytest.mark.parametrize("d, k1, k2, k3, a", [
    (7, 5, 8, 9, 10),          # where the reference disagrees with Eq. 2
    (4096, 2e-8, 6e-8, 2e-8, 2e-4),
    (4_194_304, 2e-8, 6e-8, 2e-8, 2e-4),
    (1000, 9.0, 1.0, 2.0, 50.0),
    (1000, 1.0, 1.0, 9.0, 50.0),
])
def test_optimal_integer_blocks_parity(d, k1, k2, k3, a):
    """Parity with the JAX package's function, including the point where
    it disagrees with Eq. 2 (``test_lemma1_tmin_matches_eq2``)."""
    assert (jpipeline.optimal_integer_blocks(d, k1, k2, k3, a)
            == tpipeline.optimal_integer_blocks(d, k1, k2, k3, a))
    rj = jpipeline.optimal_block_size(d, k1, k2, k3, a)
    rt = tpipeline.optimal_block_size(d, k1, k2, k3, a)
    assert (rj.b_opt, rj.t_min, rj.case) == (rt.b_opt, rt.t_min, rt.case)


def test_capacity_estimator_and_pipeline_helpers_agree():
    ej, et = jbalance.CapacityEstimator(3), tbalance.CapacityEstimator(3)
    for node, ent, sec in [(0, 100, 1.0), (1, 50, 2.0), (0, 200, 1.5)]:
        ej.update(node, ent, sec)
        et.update(node, ent, sec)
    np.testing.assert_array_equal(ej.costs, et.costs)
    np.testing.assert_array_equal(ej.rebalance_fractions(),
                                  et.rebalance_fractions())
    tn, tc, tu = [1.0, 2.0, 0.5], [2.0, 1.0, 1.0], [0.5, 0.5, 3.0]
    assert (jpipeline.simulate_lockstep(tn, tc, tu)
            == tpipeline.simulate_lockstep(tn, tc, tu))
    log = []
    res = tpipeline.run_sequential(lambda i, s: log.append(("n", i)),
                                   lambda i, s: log.append(("c", i)),
                                   lambda i, s: log.append(("u", i)), 2)
    assert log == [("n", 0), ("c", 0), ("u", 0), ("n", 1), ("c", 1),
                   ("u", 1)]
    assert res["wall_time"] >= 0.0


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 1000])
def test_pow2_agrees(n):
    assert jpow2.next_pow2(n) == tpow2.next_pow2(n)
    sel = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(jpow2.pad_pow2(sel), tpow2.pad_pow2(sel))
