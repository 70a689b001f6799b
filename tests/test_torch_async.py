"""The port's async priority model (``AsyncModel``, ``AsyncDriveLoop``,
``MeshUpperSystem.merge_partials_async``, the masked ``run_all_shards`` and
the priority buckets) against the JAX package's, on the CPU.

The JAX side is the async fused loop, ``Middleware(daemon="sharded",
upper="mesh", model=AsyncModel(...))`` over 8 shards, at whatever m its
process's CPU devices give it (``XLA_FLAGS`` asks for 8 when this module is
the first to start JAX); the port gets ``MeshUpperSystem(mesh=m)`` with that
m read from the JAX daemon, so no assertion depends on the count.  The
port's ``kernel="cuda"`` runs the CSR tile's plain version at
``CSRConfig()`` against JAX ``kernel="pallas"`` (interpret mode) at the
counterpart config; ``kernel="reference"`` is the block body on both sides.
The three arms are README's: ``eager`` (θ0=0, decay 0.5), ``holding``
(θ0=10, decay 0.9) and ``buckets`` (``holding`` with ``bucket_k=8``).

* min programs (sssp_bf, bfs, wcc) under every arm and kernel: state bit for
  bit, iterations, converged, and every record's ``run_mask``,
  ``refreshed``, ``gen_run``, ``gen_skipped``, ``theta``,
  ``shard_blocks_run`` and ``active``;
* sum programs (pagerank, label_prop): ``eager``'s records for
  ``SUM_ITERATIONS`` iterations, and ``holding`` at its fixed point;
* ``merge_partials_async`` (and the loop with a +inf identity),
  ``bucket_partials`` (tied scores),
  ``src_adjacency`` and ``_device_source_masks`` against their JAX
  counterparts on the same inputs;
* the free-hold invariants on the port alone (at ``mesh=8``), the guards
  that keep the host loop, and one device→host fetch an iteration.
"""
import os

# before JAX starts its backend: the sharded daemon wants > 1 host device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import plug as jplug  # noqa: E402
from repro.core.template import Monoid as JMonoid  # noqa: E402
from repro.graph import algorithms as jalg  # noqa: E402
from repro.graph import compaction as jcompaction  # noqa: E402
from repro.kernels.edge_block import \
    bucket_partials as jbucket_partials  # noqa: E402
from repro.plug.middleware import \
    _device_source_masks as jdevice_source_masks  # noqa: E402
from repro_torch import plug as tplug  # noqa: E402
from repro_torch.core.template import Monoid  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph import compaction as tcompaction  # noqa: E402
from repro_torch.kernels.edge_block import bucket_partials  # noqa: E402
from repro_torch.kernels.ops import CSRConfig  # noqa: E402
from repro_torch.plug.daemons import _live_edges  # noqa: E402
from repro_torch.plug.middleware import _device_source_masks  # noqa: E402
from test_torch_fused import (BLOCK, SUM_ATOL, SUM_RTOL, _graph,  # noqa: E402
                              _jax_daemon)

SHARDS = 8
CAP = 300  # iterations; tests/test_plug.py's cap for a fixed point
SUM_ITERATIONS = 12
ARMS = {"eager": dict(theta0=0.0, decay=0.5),
        "holding": dict(theta0=10.0, decay=0.9),
        "buckets": dict(theta0=10.0, decay=0.9, bucket_k=8)}
MIN_PROGRAMS = ["sssp_bf", "bfs", "wcc"]
SUM_PROGRAMS = ["pagerank", "label_prop"]
KERNELS = ["reference", "cuda"]
RECORD_KEYS = ("run_mask", "refreshed", "gen_run", "gen_skipped", "theta",
               "shard_blocks_run", "active", "blocks_run", "blocks_total",
               "devices", "async", "fused")

_jax_runs: dict = {}


def _jax_mw(prog_name, arm="eager", kernel="reference", model=None,
            upper="mesh"):
    gj, _ = _graph(prog_name)
    return jplug.Middleware(
        gj, jalg.ALGORITHMS[prog_name](gj), daemon=_jax_daemon(kernel),
        upper=upper, model=model or jplug.AsyncModel(**ARMS[arm]),
        num_shards=SHARDS, options=jplug.PlugOptions(block_size=BLOCK))


def _jax_run(prog_name, arm, kernel, max_it):
    """(result, m) of the JAX async fused loop, cached for the module."""
    key = (prog_name, arm, kernel, max_it)
    if key not in _jax_runs:
        mw = _jax_mw(prog_name, arm, kernel)
        assert mw._fused_kind == "async"
        _jax_runs[key] = (mw.run(max_iterations=max_it), mw.daemon.m)
    return _jax_runs[key]


def _port(prog_name, arm="eager", kernel="reference", m=SHARDS, model=None,
          upper=None, **kw):
    _, gt = _graph(prog_name)
    return tplug.Middleware(
        gt, talg.ALGORITHMS[prog_name](gt),
        daemon=tplug.get_daemon("sharded", kernel=kernel,
                                csr_config=CSRConfig()),
        upper=upper or tplug.MeshUpperSystem(mesh=m),
        model=model or tplug.AsyncModel(**ARMS[arm]), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu", **kw)


def _assert_same_records(got, want):
    assert len(got.per_iteration) == len(want.per_iteration)
    for a, b in zip(got.per_iteration, want.per_iteration):
        for key in RECORD_KEYS:
            assert a[key] == b[key], (a["iteration"], key, a[key], b[key])


def _holds(res, shards=SHARDS):
    """The free-hold invariant over a run's records: a device whose
    run_mask slot is False ran zero blocks.  Returns the holds seen."""
    holds = 0
    for r in res.per_iteration:
        mask = r["run_mask"]
        m = len(mask)
        per = shards // m
        assert r["gen_run"] + r["gen_skipped"] == m == r["devices"]
        for g, ran in enumerate(mask):
            if not ran:
                holds += 1
                assert sum(r["shard_blocks_run"][g * per:(g + 1) * per]) \
                    == 0, (r["iteration"], g)
    return holds


# --------------------------------------------------------------------------
# the async fused loop against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("prog_name", MIN_PROGRAMS)
def test_min_programs_match_jax_async_loop(prog_name, arm, kernel):
    want, m = _jax_run(prog_name, arm, kernel, CAP)
    mw = _port(prog_name, arm, kernel, m=m)
    assert mw._fused_kind == "async"
    assert isinstance(mw._loop, tplug.AsyncDriveLoop)
    res = mw.run(max_iterations=CAP)
    assert res.converged and want.converged
    assert res.iterations == want.iterations
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    _assert_same_records(res, want)
    _holds(res)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("prog_name", SUM_PROGRAMS)
def test_sum_programs_eager_records_match_jax(prog_name, kernel):
    """θ0 = 0 is at the floor, so every device refreshes every iteration:
    the records do not depend on the priorities' summation order."""
    want, m = _jax_run(prog_name, "eager", kernel, SUM_ITERATIONS)
    res = _port(prog_name, "eager", kernel, m=m).run(
        max_iterations=SUM_ITERATIONS)
    assert res.iterations == want.iterations == SUM_ITERATIONS
    np.testing.assert_allclose(res.state, np.asarray(want.state),
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    _assert_same_records(res, want)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("prog_name", SUM_PROGRAMS)
def test_sum_programs_holding_reach_the_fixed_point(prog_name, kernel):
    """Held to their fixed point, not to their records: a float32 sum's
    priority depends on the order it was summed in (the port's plain
    versions against XLA), so a hold decision near θ may flip, and with it
    the trajectory; the fixed point does not move."""
    want, m = _jax_run(prog_name, "holding", kernel, CAP)
    res = _port(prog_name, "holding", kernel, m=m).run(max_iterations=CAP)
    assert res.converged and want.converged
    np.testing.assert_allclose(res.state, np.asarray(want.state),
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    _, gt = _graph(prog_name)
    ref, _ = tplug.run_reference(gt, talg.ALGORITHMS[prog_name](gt),
                                 max_iterations=CAP, device="cpu")
    np.testing.assert_allclose(res.state, ref, rtol=SUM_RTOL, atol=SUM_ATOL)
    _holds(res)


# --------------------------------------------------------------------------
# units against their JAX counterparts
# --------------------------------------------------------------------------
def _inf_sssp(prog, monoid):
    """sssp_bf with a +inf identity instead of float32 max: ``|inf - inf|``
    is NaN, the case the priority's NaN handling is for."""

    def init(graph, _init=prog.init):
        state, aux = _init(graph)
        state[state >= np.finfo(np.float32).max] = np.inf
        return state, aux

    return dataclasses.replace(prog, monoid=monoid, init=init)


def _merge_inputs(case, m, n, k, identity):
    rng = np.random.default_rng(len(case))
    fmax = np.finfo(np.float32).max
    run_mask = np.ones(m, bool)
    if case == "inf_one_message":
        held_p = np.full((m, n, k), identity, np.float32)
        held_c = np.zeros((m, n), np.int32)
        fresh_p, fresh_c = held_p.copy(), held_c.copy()
        fresh_p[0, 0, :] = 1.0
        fresh_c[0, 0] = 1
        return fresh_p, fresh_c, held_p, held_c, 0.5, None
    # random partials with message-free slots at the identity, values at
    # ±float32 max (their difference overflows to inf and must clamp),
    # and half the devices held (a held row is a bucket partial)
    fresh_c = rng.integers(0, 3, (m, n)).astype(np.int32)
    held_c = rng.integers(0, 3, (m, n)).astype(np.int32)
    fresh_p = rng.uniform(-5, 5, (m, n, k)).astype(np.float32)
    held_p = rng.uniform(-5, 5, (m, n, k)).astype(np.float32)
    fresh_p[fresh_c == 0] = identity
    held_p[held_c == 0] = identity
    fresh_p[0, :3, 0] = -fmax
    held_p[0, :3, 0] = fmax
    fresh_c[0, :3] = 1
    held_c[0, :3] = 1
    run_mask[1::2] = False
    theta = {"random": 2.0, "random_floor": 0.0, "random_all": 1e30}[case]
    return fresh_p, fresh_c, held_p, held_c, theta, run_mask


@pytest.mark.parametrize("prog_name, case", [
    ("sssp_bf", "inf_one_message"), ("sssp_bf", "random"),
    ("sssp_bf", "random_floor"), ("sssp_bf", "random_all"),
    ("pagerank", "random"), ("pagerank", "random_floor"),
    ("pagerank", "random_all")])
def test_merge_partials_async_matches_jax(prog_name, case):
    """Every output of the commit half equals JAX's: the canonicalised
    priorities (finite, NaN counting 0, ±inf clamped), the refresh mask,
    the held copies (buckets folded in for min, carried for sum) and the
    merged aggregate."""
    gj, gt = _graph(prog_name)
    jprog = jalg.ALGORITHMS[prog_name](gj)
    tprog = talg.ALGORITHMS[prog_name](gt)
    if case == "inf_one_message":
        jprog = _inf_sssp(jprog, JMonoid("min", float("inf"), jnp.minimum,
                                         idempotent=True))
        tprog = _inf_sssp(tprog, Monoid("min", float("inf"), torch.minimum,
                                        idempotent=True))
    mj = jplug.Middleware(gj, jprog, daemon="sharded", upper="mesh",
                          model="async", num_shards=SHARDS,
                          options=jplug.PlugOptions(block_size=BLOCK))
    m = mj.daemon.m
    upper = tplug.MeshUpperSystem(mesh=m).bind(tprog, SHARDS)
    fp, fc, hp, hc, theta, run_mask = _merge_inputs(
        case, m, gj.num_vertices, jprog.state_width, jprog.monoid.identity)
    jmask = None if run_mask is None else jnp.asarray(run_mask)
    want = mj.upper.merge_partials_async(
        jnp.asarray(fp), jnp.asarray(fc), jnp.asarray(hp), jnp.asarray(hc),
        jnp.float32(theta), 1e-12, jmask)
    got = upper.merge_partials_async(
        *(torch.from_numpy(a) for a in (fp, fc, hp, hc)),
        torch.tensor(theta, dtype=torch.float32), 1e-12,
        None if run_mask is None else torch.from_numpy(run_mask))
    names = ("agg", "cnt", "held_p", "held_c", "refreshed", "pri")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if name == "agg" and not tprog.monoid.idempotent:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    pri, refreshed = got[5].numpy(), got[4].numpy()
    assert np.isfinite(pri).all()
    if case == "inf_one_message":
        assert refreshed[0] and not refreshed[1:].any()


@pytest.mark.parametrize("kernel", KERNELS)
def test_inf_identity_loop_matches_jax(kernel):
    """sssp_bf with a +inf identity through the async loop: devices with
    real movement refresh while θ is far above the floor (a NaN priority
    would hold them until θ collapsed), and state and records equal JAX's
    run of the same program."""
    gj, gt = _graph("sssp_bf")
    jprog = _inf_sssp(jalg.sssp_bf(gj), JMonoid(
        "min", float("inf"), jnp.minimum, idempotent=True))
    tprog = _inf_sssp(talg.sssp_bf(gt), Monoid(
        "min", float("inf"), torch.minimum, idempotent=True))
    arm = dict(theta0=10.0, decay=0.5)
    mj = jplug.Middleware(gj, jprog, daemon=_jax_daemon(kernel),
                          upper="mesh", model=jplug.AsyncModel(**arm),
                          num_shards=SHARDS,
                          options=jplug.PlugOptions(block_size=BLOCK))
    want = mj.run(max_iterations=CAP)
    mt = tplug.Middleware(
        gt, tprog, daemon=tplug.get_daemon("sharded", kernel=kernel,
                                           csr_config=CSRConfig()),
        upper=tplug.MeshUpperSystem(mesh=mj.daemon.m),
        model=tplug.AsyncModel(**arm), num_shards=SHARDS,
        options=tplug.PlugOptions(block_size=BLOCK), device="cpu")
    assert mt._fused_kind == "async"
    res = mt.run(max_iterations=CAP)
    assert res.converged and want.converged
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    _assert_same_records(res, want)
    early = [r for r in res.per_iteration if r["theta"] > 1e3 * 1e-12]
    assert early and any(r["refreshed"] > 0 for r in early)


def _bucket_inputs(seed, n, k_state):
    rng = np.random.default_rng(seed)
    state = rng.uniform(0.0, 50.0, (n, k_state)).astype(np.float32)
    # ties: scores from a few levels, some at 0 and -1 (never run)
    scores = rng.choice(np.array([-1.0, 0.0, 0.5, 2.0, 2.0, 3.0],
                                 np.float32), n)
    return state, scores


@pytest.mark.parametrize("k, cap", [(8, 32), (40, 4), (3, 1), (300, 8)])
def test_bucket_partials_with_tied_scores_matches_jax(k, cap):
    """The top k among tied scores are the lower indices, as
    ``jax.lax.top_k`` takes them: the partials are bit-equal."""
    gj, gt = _graph("sssp_bf")
    mw = _port("sssp_bf", m=2)
    n = gt.num_vertices
    adjs = [tcompaction.src_adjacency(*_live_edges(bs), n)
            for bs in mw.blocksets[:4]]
    ep = max(a[1].shape[0] for a in adjs)
    ptr = np.stack([a[0] for a in adjs])
    adst = np.stack([np.pad(a[1], (0, ep - a[1].shape[0])) for a in adjs])
    aw = np.stack([np.pad(a[2], (0, ep - a[2].shape[0])) for a in adjs])
    state, scores = _bucket_inputs(k + cap, n, 4)
    k = min(k, n)
    aux = np.zeros((n, 0), np.float32)
    want = jbucket_partials(
        *(jnp.asarray(a) for a in (state, aux, scores, ptr, adst, aw)),
        program=jalg.sssp_bf(gj), k=k, cap=cap, num_vertices=n)
    got = bucket_partials(
        *(torch.from_numpy(a) for a in (state, aux, scores, ptr, adst, aw)),
        program=talg.sssp_bf(gt), k=k, cap=cap, num_vertices=n)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 0


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("n, e", [(50, 400), (7, 0), (300, 1)])
def test_src_adjacency_matches_jax(n, e, weighted):
    rng = np.random.default_rng(n + e)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.uniform(0, 1, e).astype(np.float32) if weighted else None
    got = tcompaction.src_adjacency(src, dst, w, n)
    want = jcompaction.src_adjacency(src, dst, w, n)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_device_source_masks_match_jax(m):
    gj, gt = _graph("sssp_bf")
    mj = jplug.Middleware(gj, jalg.sssp_bf(gj), num_shards=SHARDS,
                          options=jplug.PlugOptions(block_size=BLOCK))
    mt = _port("sssp_bf", m=m)
    got = _device_source_masks(mt.partitions, m, gt.num_vertices)
    want = jdevice_source_masks(mj.partitions, m, gj.num_vertices)
    np.testing.assert_array_equal(got, want)
    has_edge = np.zeros(gt.num_vertices, bool)
    has_edge[np.unique(gt.src)] = True
    np.testing.assert_array_equal(got.any(axis=0), has_edge)


# --------------------------------------------------------------------------
# the free hold, on the port alone
# --------------------------------------------------------------------------
def _reference(prog_name):
    _, gt = _graph(prog_name)
    return tplug.run_reference(gt, talg.ALGORITHMS[prog_name](gt),
                               max_iterations=CAP, device="cpu")[0]


@pytest.mark.parametrize("kernel", KERNELS)
def test_held_device_runs_zero_blocks_and_gen_counts_match(kernel):
    """Holds happen under ``holding``; every held device ran no block; the
    instrumented daemon ran exactly Σ gen_run device bodies."""
    mw = _port("sssp_bf", "holding", kernel)
    mw.daemon.instrument = True
    mw.daemon.reset_counters()
    res = mw.run(max_iterations=CAP)
    assert res.converged
    assert _holds(res) > 0
    assert sum(r["gen_skipped"] for r in res.per_iteration) > 0
    assert mw.daemon.gen_invocations == sum(r["gen_run"]
                                            for r in res.per_iteration)
    assert mw.daemon.bucket_invocations == 0
    np.testing.assert_array_equal(res.state, _reference("sssp_bf"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_zero_theta_never_holds_and_equals_bsp(kernel):
    """θ0 = 0 is at the floor: no device ever holds, and the trajectory is
    the barriered one bit for bit (a drained device may still skip)."""
    mw = _port("sssp_bf", "eager", kernel)
    mw.daemon.instrument = True
    mw.daemon.reset_counters()
    res = mw.run(max_iterations=CAP)
    assert res.converged
    assert all(all(r["run_mask"]) for r in res.per_iteration)
    assert all(r["theta"] == 0.0 for r in res.per_iteration)
    _holds(res)
    assert mw.daemon.gen_invocations == sum(r["gen_run"]
                                            for r in res.per_iteration)
    bsp = _port("sssp_bf", kernel=kernel, model="bsp")
    assert bsp._fused_kind == "bsp"
    want = bsp.run(max_iterations=CAP)
    np.testing.assert_array_equal(res.state, want.state)
    assert res.iterations == want.iterations


@pytest.mark.parametrize("kernel", KERNELS)
def test_drained_backlog_row_skips_its_body(kernel):
    """A device whose private frontier row is empty runs no body even with
    its run_mask slot True, and its identity output is the exact fresh
    partial; the other devices' partials are those of the unmasked pass."""
    mw = _port("sssp_bf", kernel=kernel)
    daemon, prog = mw.daemon, mw.program
    m, n = daemon.m, mw.n
    state, aux = (torch.from_numpy(a) for a in prog.init(mw.graph))
    backlog = torch.ones((m, n), dtype=torch.bool)
    backlog[0] = False
    daemon.instrument = True
    daemon.reset_counters()
    p, c, blocks = daemon.run_all_shards(
        state, aux, backlog, run_mask=[True] * m,
        residual=torch.zeros(n))
    assert daemon.gen_invocations == m - 1
    per = SHARDS // m
    assert blocks[:per].sum() == 0
    assert (c[0] == 0).all() and (p[0] == prog.monoid.identity).all()
    p_ref, c_ref, b_ref = daemon.run_all_shards(state, aux, backlog)
    assert torch.equal(p, p_ref) and torch.equal(c, c_ref)
    assert torch.equal(blocks, b_ref)
    # the rows the caller already fetched give the same pass
    again = daemon.run_all_shards(
        state, aux, backlog, run_mask=np.ones(m, bool),
        residual=torch.zeros(n), live_rows=[False] + [True] * (m - 1))
    assert all(torch.equal(a, b) for a, b in zip(again, (p, c, blocks)))
    assert daemon.gen_invocations == 2 * (m - 1)


@pytest.mark.parametrize("kernel", KERNELS)
def test_buckets_keep_the_fixed_point_bit_exact(kernel):
    mw = _port("sssp_bf", "buckets", kernel)
    mw.daemon.instrument = True
    mw.daemon.reset_counters()
    res = mw.run(max_iterations=CAP)
    assert res.converged
    _holds(res)
    assert "bucket" in mw.daemon.stacked
    assert mw.daemon.bucket_invocations == sum(r["gen_skipped"]
                                               for r in res.per_iteration) > 0
    np.testing.assert_array_equal(res.state, _reference("sssp_bf"))


def test_buckets_are_disarmed_for_sums():
    mw = _port("pagerank", model=tplug.AsyncModel(theta0=1.0, decay=0.9,
                                                  bucket_k=8))
    res = mw.run(max_iterations=120)
    assert res.converged
    assert mw.daemon._bucket_k == 0
    assert "bucket" not in mw.daemon.stacked


# --------------------------------------------------------------------------
# guards: what keeps the host loop or the run-everything cadence
# --------------------------------------------------------------------------
class _HookedAsync(tplug.AsyncModel):
    def aggregates(self, gather, pending, record):
        record["hooked"] = True
        return gather(record)


def test_hook_overriding_async_subclass_keeps_the_host_loop():
    mw = _port("sssp_bf", model=_HookedAsync(theta0=10.0, decay=0.9))
    assert mw._fused_kind is None
    assert isinstance(mw._loop, tplug.HostDriveLoop)
    res = mw.run(max_iterations=CAP)
    assert all(r["hooked"] for r in res.per_iteration)
    np.testing.assert_array_equal(res.state, _reference("sssp_bf"))
    # a subclass that keeps the hooks still fuses
    kept = type("MyAsync", (tplug.AsyncModel,), {})()
    assert _port("sssp_bf", model=kept)._fused_kind == "async"


class _NoAsyncMerge(tplug.MeshUpperSystem):
    merge_partials_async = None


def test_upper_without_merge_partials_async_keeps_the_host_loop():
    mw = _port("sssp_bf", "holding", upper=_NoAsyncMerge(mesh=SHARDS))
    assert mw._fused_kind is None
    assert _port("sssp_bf", "holding", model="bsp",
                 upper=_NoAsyncMerge(mesh=SHARDS))._fused_kind == "bsp"
    np.testing.assert_array_equal(mw.run(max_iterations=CAP).state,
                                  _reference("sssp_bf"))


class _JaxUnmasked(jplug.MeshUpperSystem):
    def merge_partials_async(self, fresh_p, fresh_c, held_p, held_c, theta,
                             floor):
        return super().merge_partials_async(fresh_p, fresh_c, held_p, held_c,
                                            theta, floor)


class _Unmasked(tplug.MeshUpperSystem):
    def merge_partials_async(self, fresh_p, fresh_c, held_p, held_c, theta,
                             floor):
        return super().merge_partials_async(fresh_p, fresh_c, held_p, held_c,
                                            theta, floor)


def test_unmasked_upper_runs_every_device_as_jax_does():
    """An async merge that takes no run_mask gets the run-everything
    cadence, on both sides: every device runs every iteration."""
    mj = _jax_mw("sssp_bf", "holding", upper=_JaxUnmasked())
    want = mj.run(max_iterations=CAP)
    mw = _port("sssp_bf", "holding", m=mj.daemon.m, upper=_Unmasked(
        mesh=mj.daemon.m))
    assert mw._fused_kind == "async" and not mw._loop._maskable
    res = mw.run(max_iterations=CAP)
    assert res.converged and res.iterations == want.iterations
    np.testing.assert_array_equal(res.state, np.asarray(want.state))
    _assert_same_records(res, want)
    assert all(r["gen_skipped"] == 0 for r in res.per_iteration)


@pytest.mark.parametrize("prog_name", ["sssp_bf", "pagerank"])
def test_async_on_the_host_loop_equals_jax_host_loop(prog_name):
    gj, gt = _graph(prog_name)
    max_it = SUM_ITERATIONS if prog_name == "pagerank" else None
    mj = jplug.Middleware(gj, jalg.ALGORITHMS[prog_name](gj),
                          model=jplug.AsyncModel(theta0=10.0, decay=0.9),
                          num_shards=4,
                          options=jplug.PlugOptions(block_size=BLOCK))
    mt = tplug.Middleware(gt, talg.ALGORITHMS[prog_name](gt),
                          model=tplug.AsyncModel(theta0=10.0, decay=0.9),
                          num_shards=4,
                          options=tplug.PlugOptions(block_size=BLOCK),
                          device="cpu")
    assert mj._fused_kind is None and mt._fused_kind is None
    want, res = mj.run(max_iterations=max_it), mt.run(max_iterations=max_it)
    assert res.iterations == want.iterations
    assert res.converged == want.converged
    assert res.stats.as_dict() == want.stats.as_dict()
    if prog_name == "pagerank":
        np.testing.assert_allclose(res.state, np.asarray(want.state),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(res.state, np.asarray(want.state))


def test_async_model_checks_its_arguments():
    for kwargs in (dict(decay=0.0), dict(decay=1.0), dict(theta0=-1.0),
                   dict(floor=-1.0), dict(bucket_k=-1), dict(bucket_cap=0)):
        with pytest.raises(ValueError):
            tplug.AsyncModel(**kwargs)
        with pytest.raises(ValueError):
            jplug.AsyncModel(**kwargs)
    model = tplug.get_model("async")
    assert isinstance(model, tplug.PriorityAsyncModel)
    assert model.barrier is False and model.order == ("gen", "merge", "apply")
    with pytest.raises(ValueError, match="cap"):
        _port("sssp_bf").daemon.configure_buckets(4, cap=0)


# --------------------------------------------------------------------------
# one device→host fetch an iteration
# --------------------------------------------------------------------------
_TRANSFERS = ("cpu", "tolist", "item", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.mark.parametrize("arm", ["holding", "buckets"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_one_fetch_an_iteration(kernel, arm, monkeypatch):
    """Inside the async loop no vertex-sized tensor reaches the host and
    exactly one small fetch is made an iteration (the hold verdict rides
    it); the final state crosses once.  Counted as
    tests/test_torch_fused.py counts it."""
    mw = _port("sssp_bf", arm, kernel)
    n = mw.n
    mw.run(max_iterations=2)  # set-up: the buckets' placement
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
    res = mw.run(max_iterations=CAP)
    assert res.converged and _holds(res) > 0
    big = [c for c in calls if c[1] >= n]
    small = [c for c in calls if c[1] < n]
    assert big == [("cpu", n * mw.k)]
    assert [c[0] for c in small] == ["tolist"] * res.iterations
