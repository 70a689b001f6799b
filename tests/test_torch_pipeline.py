"""The pipeline shuffle of the port (``core/pipeline.PipelinedExecutor``,
``calibrate``) and its streaming daemons (``"blocked"``, ``"pipelined"``,
``"naive"``) against the JAX package, on the CPU.

* The executor keeps the JAX executor's contract: stage callables take
  ``(block, slot)``, three slots rotate, ``run`` returns ``wall_time`` and
  per-stage ``busy``, a stage's error reaches the caller, and every thread
  has ended when ``run`` returns.
* ``calibrate`` equals the JAX package's on the same samples.
* The daemons run through the port's ``Middleware(device="cpu")`` against
  the JAX package's ``Middleware`` with the same daemon name, on the same
  graph: min programs bit-equal with equal iterations and ``SyncStats``,
  sum programs (a fixed ``MAX_IT`` iterations) within rtol=1e-5,
  atol=1e-6, as in tests/test_torch_plug.py.

No test reads a time beyond its presence and sign.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro import plug as jplug
from repro.core import pipeline as jpipeline
from repro.graph import algorithms as jalg
from repro.graph import generate as jgenerate
from repro_torch import convert
from repro_torch import plug as tplug
from repro_torch.core import pipeline as tpipeline
from repro_torch.graph import algorithms as talg

MAX_IT = 12
BLOCK = 128  # ≥ 8 blocks a shard at 3 shards
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ["pagerank", "sssp_bf", "wcc", "bfs", "label_prop"]
DAEMONS = ["blocked", "pipelined", "naive"]
RECORD_KEY = {"blocked": "sequential", "pipelined": "pipeline"}

_graphs: dict = {}
_jax_runs: dict = {}


def _graph(prog_name):
    """(JAX graph, port graph) — the port's carried across as arrays."""
    if prog_name not in _graphs:
        gj = jgenerate.rmat(512, 4096, seed=7)
        if prog_name == "wcc":
            gj = gj.with_reverse_edges()
        _graphs[prog_name] = (gj, convert.graph_from_arrays(
            gj.src, gj.dst, gj.weights, gj.num_vertices))
    return _graphs[prog_name]


def _max_it(prog_name):
    return MAX_IT if prog_name in ("pagerank", "label_prop") else None


def _jax_run(prog_name, model, daemon, shards):
    key = (prog_name, model, daemon, shards)
    if key not in _jax_runs:
        gj, _ = _graph(prog_name)
        mw = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                              daemon=daemon, model=model, num_shards=shards,
                              options=jplug.PlugOptions(block_size=BLOCK))
        _jax_runs[key] = mw.run(max_iterations=_max_it(prog_name))
    return _jax_runs[key]


def _stages(out):
    def download(i, slot):
        slot["x"] = i * 10

    def compute(i, slot):
        slot["y"] = slot["x"] + 1

    def upload(i, slot):
        out.append((i, slot["y"]))

    return download, compute, upload


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------
@pytest.mark.parametrize("num_blocks", [1, 2, 3, 16])
def test_executor_matches_run_sequential(num_blocks):
    """The 3-thread rotating-slot executor gives the outputs of sequential
    execution, in block order, and the JAX executor's record keys."""
    seq, pipe, jax_pipe = [], [], []
    before = threading.active_count()
    rs = tpipeline.run_sequential(*_stages(seq), num_blocks)
    rp = tpipeline.PipelinedExecutor(*_stages(pipe)).run(num_blocks)
    rj = jpipeline.PipelinedExecutor(*_stages(jax_pipe)).run(num_blocks)
    want = [(i, i * 10 + 1) for i in range(num_blocks)]
    assert seq == pipe == jax_pipe == want
    assert threading.active_count() == before
    for res in (rs, rp):
        assert set(res) == set(rj) == {"wall_time", "busy"}
        assert set(res["busy"]) == set(rj["busy"])
        assert res["wall_time"] >= 0.0
        assert all(v >= 0.0 for v in res["busy"].values())


def test_executor_rotates_three_slots_by_pointer():
    """Block i lives in one slot object from download to upload, slot
    i % 3, and three slots serve all blocks."""
    seen: dict = {}
    lock = threading.Lock()

    def note(stage):
        def fn(i, slot):
            with lock:
                seen.setdefault(i, {})[stage] = id(slot)
        return fn

    tpipeline.PipelinedExecutor(note("n"), note("c"), note("u")).run(9)
    assert all(len(set(s.values())) == 1 for s in seen.values())
    slot_of = [seen[i]["n"] for i in range(9)]
    assert len(set(slot_of)) == 3
    assert all(slot_of[i] == slot_of[i % 3] for i in range(9))


@pytest.mark.parametrize("stage", tpipeline.STAGES)
def test_executor_reraises_a_stage_error_and_ends_its_threads(stage):
    before = threading.active_count()
    ran = []

    def fail(i, slot):
        if i == 2:
            raise RuntimeError(f"{stage} failed on block {i}")
        ran.append(i)

    stages = {s: (lambda i, slot: None) for s in tpipeline.STAGES}
    stages[stage] = fail
    with pytest.raises(RuntimeError, match=f"{stage} failed on block 2"):
        tpipeline.PipelinedExecutor(*stages.values()).run(8)
    assert threading.active_count() == before
    assert ran == [0, 1]


@pytest.mark.parametrize("stage", tpipeline.STAGES)
def test_executor_times_out_a_stuck_stage_instead_of_hanging(stage):
    """A stage that outlasts the barrier's timeout breaks the pipeline and
    ``run`` raises ``TimeoutError`` naming it; once released, the stage
    finds the barrier broken and its thread ends."""
    before = threading.active_count()
    release = threading.Event()

    def stuck(i, slot):
        if i == 1:
            release.wait(10.0)

    stages = {s: (lambda i, slot: None) for s in tpipeline.STAGES}
    stages[stage] = stuck
    try:
        with pytest.raises(TimeoutError, match=f"pipeline-{stage}"):
            tpipeline.PipelinedExecutor(*stages.values(),
                                        timeout=0.2).run(4)
    finally:
        release.set()
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# --------------------------------------------------------------------------
# calibrate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibrate_equals_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [(int(b), *rng.uniform(1e-5, 1e-2, 3))
               for b in rng.integers(64, 1 << 18, 7)]
    got = tpipeline.calibrate(samples)
    want = jpipeline.calibrate(samples)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_calibrate_recovers_coefficients():
    """tests/test_pipeline.py's recovery case, through the port."""
    rng = np.random.default_rng(0)
    k1, k2, k3, a = 2e-6, 7e-6, 3e-6, 5e-4
    samples = []
    for b in [64, 128, 256, 512, 1024]:
        noise = 1 + 0.01 * rng.standard_normal(3)
        samples.append((b, k1 * b * noise[0], a + k2 * b * noise[1],
                        k3 * b * noise[2]))
    e1, e2, e3, ea = tpipeline.calibrate(samples)
    assert e1 == pytest.approx(k1, rel=0.1)
    assert e2 == pytest.approx(k2, rel=0.1)
    assert e3 == pytest.approx(k3, rel=0.1)
    assert ea == pytest.approx(a, rel=0.3)


# --------------------------------------------------------------------------
# the streaming daemons through the middleware
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("model", ["bsp", "gas"])
@pytest.mark.parametrize("prog_name", PROGRAMS)
@pytest.mark.parametrize("daemon", DAEMONS)
def test_streaming_daemons_match_jax(daemon, prog_name, model, shards):
    _, gt = _graph(prog_name)
    prog = talg.ALGORITHMS[prog_name](gt)
    mw = tplug.Middleware(gt, prog, daemon=daemon, model=model,
                          num_shards=shards,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert min(bs.num_blocks for bs in mw.blocksets) >= 8
    res = mw.run(max_iterations=_max_it(prog_name))
    want = _jax_run(prog_name, model, daemon, shards)
    assert res.iterations == want.iterations
    assert res.converged == want.converged
    assert res.stats.as_dict() == want.stats.as_dict()
    assert [r.get("blocks_run") for r in res.per_iteration] == \
        [r.get("blocks_run") for r in want.per_iteration]
    if prog.monoid.idempotent:
        np.testing.assert_array_equal(res.state, np.asarray(want.state))
    else:
        np.testing.assert_allclose(res.state, np.asarray(want.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    key = RECORD_KEY.get(daemon)
    if key is None:
        assert not any("pipeline" in r or "sequential" in r
                       for r in res.per_iteration)
        return
    # an executor record wherever JAX has one (a shard that ran blocks)
    assert [len(r.get(key, ())) for r in res.per_iteration] == \
        [len(r.get(key, ())) for r in want.per_iteration]
    recs = [rec for r in res.per_iteration for rec in r.get(key, ())]
    assert recs
    for rec in recs:
        assert rec["wall_time"] >= 0.0
        assert set(rec["busy"]) == {"download", "compute", "upload"}
        assert all(v >= 0.0 for v in rec["busy"].values())


@pytest.mark.parametrize("prog_name", PROGRAMS)
def test_pipelined_and_blocked_daemons_give_the_same_aggregates(prog_name):
    """One shard's aggregate for the same block selections, straight from
    ``run_blocks``: the pipelined and blocked daemons run the same block
    programs, so min and sum alike are equal bit for bit."""
    _, gt = _graph(prog_name)
    prog = talg.ALGORITHMS[prog_name](gt)
    mw = tplug.Middleware(gt, prog, daemon="blocked", num_shards=1,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    bs = mw.blocksets[0]
    state, aux = prog.init(gt)
    daemons = [tplug.get_daemon(name).bind(prog, gt.num_vertices,
                                           device="cpu")
               for name in ("blocked", "pipelined")]
    rng = np.random.default_rng(3)
    for sel in (np.arange(bs.num_blocks), np.arange(1),
                np.sort(rng.choice(bs.num_blocks, 5, replace=False))):
        (ab, cb), (ap, cp) = (d.run_blocks(state, aux, bs, sel, {})
                              for d in daemons)
        np.testing.assert_array_equal(ap, ab)
        np.testing.assert_array_equal(cp, cb)


@pytest.mark.parametrize("daemon", DAEMONS)
def test_custom_monoid_without_a_host_rule_raises(daemon):
    """tests/test_plug.py's unknown-monoid regression, for the port: the
    streaming upload and the naive loop merge through the monoid, which
    raises for a monoid it has no rule for instead of max-merging."""
    from repro_torch.core.template import Monoid

    _, gt = _graph("pagerank")
    prog = dataclasses.replace(
        talg.pagerank(gt),
        monoid=Monoid("product", 1.0, torch.mul, idempotent=False))
    mw = tplug.Middleware(gt, prog, daemon=daemon, num_shards=1,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    before = threading.active_count()
    with pytest.raises(ValueError, match="product"):
        mw.run(max_iterations=2)
    assert threading.active_count() == before


def test_registry_names_the_streaming_daemons():
    names = set(tplug.daemon_names())
    assert {"blocked", "pipelined", "naive"} <= names
    assert {"blocked", "pipelined", "naive"} <= set(jplug.daemon_names())
    assert isinstance(tplug.get_daemon("pipelined"), tplug.PipelinedDaemon)
    assert isinstance(tplug.get_daemon("naive"), tplug.NaiveDaemon)
    assert tplug.get_daemon("pipelined", kernel="cuda").kernel == "cuda"
    with pytest.raises(ValueError, match="kernel"):
        tplug.get_daemon("pipelined", kernel="pallas")


def test_naive_daemon_takes_device_for_the_protocol_only():
    """The naive daemon computes on the host whatever the device; asking it
    for CUDA on a machine without a GPU still raises."""
    _, gt = _graph("bfs")
    prog = talg.bfs(gt)
    daemon = tplug.NaiveDaemon().bind(prog, gt.num_vertices, device="cpu")
    assert daemon.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tplug.NaiveDaemon().bind(prog, gt.num_vertices)
