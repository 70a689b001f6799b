"""Rank entries for tests/test_torch_ranks.py and tests/test_torch_cuda.py.

``launch.mesh.spawn_ranks`` runs these in spawned processes, one per rank
of a gloo world.  They import ``repro_torch`` and nothing of the JAX
package: the JAX oracles run in the parent test process.
"""
import sys
import time

import numpy as np
import torch

from repro_torch import plug
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import RankMesh
from repro_torch.graph import algorithms as talg
from repro_torch.kernels.autotune import CSRConfig

PROGRAMS = ("sssp_bf", "bfs", "wcc", "pagerank", "label_prop")
MODELS = ("bsp", "gas")
SUM_PROGRAMS = ("pagerank", "label_prop")
MAX_IT = 12
BLOCK = 64
WIRE_BITS = (8, 4)
WIRE_FORMATS = ("int8", "emulated")
WIRE_WIDTH = 32


def max_it(prog_name):
    return MAX_IT if prog_name in SUM_PROGRAMS else None


def _run_record(res, upper=None) -> dict:
    out = {"state": np.asarray(res.state), "iterations": res.iterations,
           "converged": res.converged, "stats": res.stats.as_dict(),
           "records": [{k: v for k, v in r.items()
                        if k not in ("shard_busy_s",)}
                       for r in res.per_iteration]}
    if upper is not None:
        out["wire_stats"] = dict(upper.wire_stats)
    return out


def middleware(graph, prog_name, loop, model, shards, mesh, device,
               upper_kw=None):
    """The composition a case runs: the fused loop (``ShardedDaemon``
    through the CSR tile, its config pinned) or the host loop (the
    vectorized daemon through the CSR tile) over ``MeshUpperSystem``;
    ``mesh`` a RankMesh or an int m."""
    prog = talg.ALGORITHMS[prog_name](graph)
    if loop == "fused":
        daemon = plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                    csr_config=CSRConfig())
    else:
        daemon = plug.VectorizedDaemon(kernel="cuda", csr_config=CSRConfig())
    upper = plug.MeshUpperSystem(mesh=mesh, **(upper_kw or {}))
    kw = {} if isinstance(mesh, RankMesh) else {"device": device}
    return plug.Middleware(graph, prog, daemon=daemon, upper=upper,
                           model=model, num_shards=shards,
                           options=plug.PlugOptions(block_size=BLOCK), **kw)


def _cases():
    for prog_name in PROGRAMS:
        for model in MODELS:
            for loop in ("fused", "host"):
                yield (loop, prog_name, model), {}
    for bits in WIRE_BITS:
        yield (("host", "pagerank", "bsp", f"compressed{bits}"),
               {"wire": "compressed", "bits": bits})


def _graph_for(graphs, prog_name):
    return graphs["wcc" if prog_name == "wcc" else "directed"]


def _run_case(graphs, key, upper_kw, shards, mesh, device):
    loop, prog_name, model = key[:3]
    mw = middleware(_graph_for(graphs, prog_name), prog_name, loop, model,
                    shards, mesh, device, upper_kw)
    want_loop = plug.DriveLoop if loop == "fused" else plug.HostDriveLoop
    if not isinstance(mw._loop, want_loop):
        raise AssertionError(f"{key}: ran {type(mw._loop).__name__}")
    res = mw.run(max_iterations=max_it(prog_name))
    out = _run_record(res, mw.upper)
    out["m"] = mw.upper.m
    return out


def _wire(mesh, rank, local, m):
    """The rank wire at each (bits, format): two error-feedback rounds on
    seeded (m, WIRE_WIDTH) inputs, of which this rank holds its local
    devices' rows."""
    out = {}
    rows = slice(rank * local, (rank + 1) * local)
    for bits in WIRE_BITS:
        for fmt in WIRE_FORMATS:
            run = C.make_compressed_allreduce(mesh, bits=bits, wire=fmt)
            rng = np.random.default_rng(100 + bits)
            res = torch.from_numpy(
                rng.standard_normal((m, WIRE_WIDTH)).astype(np.float32)
                [rows].reshape(-1) * 0.01)
            rounds = []
            for _ in range(2):
                x = rng.standard_normal((m, WIRE_WIDTH)).astype(np.float32)
                means, res = run(torch.from_numpy(x[rows].reshape(-1)), res)
                rounds.append((means.numpy().copy(), res.numpy().copy()))
            out[(bits, fmt)] = rounds
    return out


def _refusals(graphs, shards, mesh) -> dict:
    """What a RankMesh does not reach yet, and bad compositions: each
    case's exception as ``(type name, message)``, or None if it ran.
    ``mesh`` may be an int m: the one-process errors of the same cases."""
    g = graphs["directed"]
    prog = talg.sssp_bf(g)
    opts = plug.PlugOptions(block_size=BLOCK)

    def mw(**kw):
        kw.setdefault("daemon", plug.ShardedDaemon(
            kernel="cuda", mesh=mesh, csr_config=CSRConfig()))
        kw.setdefault("upper", plug.MeshUpperSystem(mesh=mesh))
        return plug.Middleware(g, kw.pop("program", prog), num_shards=kw.pop(
            "num_shards", shards), options=opts, **kw)

    def run_built(method, *args):
        return lambda: getattr(mw(), method)(*args)

    cases = {
        "bad_monitor": lambda: mw(monitor=object()),
        "bad_mutations": lambda: mw(mutations=object()).run(),
        "migrate_without_monitor": run_built("migrate"),
        "moe": lambda: _moe_under(mesh),
        "shards_not_divisible": lambda: mw(num_shards=mesh.size * 2 + 1),
        "host_upper": lambda: mw(upper="host"),
        "int_daemon_mesh": lambda: mw(daemon=plug.ShardedDaemon(
            kernel="cuda", mesh=mesh.size, csr_config=CSRConfig())),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except Exception as e:  # reported to the parent, which asserts
            out[name] = (type(e).__name__, str(e))
    return out


def _moe_under(mesh):
    """``moe_ffn`` under an activation_sharding context over the RankMesh
    (no "model" axis: the local path, as in the JAX package) → raises
    unless it equals the one-process result bit for bit."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    cfg = get_reduced("qwen3-moe-235b-a22b").replace(dtype="float32")
    p = L.ParamNode(moe.moe_leaves(cfg))
    p.init_(torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want = moe.moe_ffn(p, x, cfg, return_aux=True)
    with shd.activation_sharding(mesh, {}):
        got = moe.moe_ffn(p, x, cfg, return_aux=True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("moe_ffn under the RankMesh differs from the "
                             "local path")


def cpu_world(rank, world, graphs, shards, local):
    """One rank of a CPU world: every case of :func:`_cases` over a
    RankMesh of ``world`` ranks × ``local`` logical devices, then this
    rank's share of the same cases at the single-process ``mesh=m``, the
    rank wire and the refusals."""
    torch.set_num_threads(1)
    mesh = RankMesh(local=local, device="cpu")
    m = mesh.size
    cases = list(_cases())
    out = {"rank": rank, "m": m, "shards": list(mesh.shard_range(shards)),
           "ranks": {}, "single": {}}
    for key, kw in cases:
        out["ranks"][key] = _run_case(graphs, key, kw, shards, mesh, "cpu")
    for i, (key, kw) in enumerate(cases):
        if i % world == rank:
            out["single"][key] = _run_case(graphs, key, kw, shards, m, "cpu")
    out["wire"] = _wire(mesh, rank, local, m)
    out["refusals"] = _refusals(graphs, shards, mesh)
    out["imports"] = sorted(
        name for name in sys.modules
        if name.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def example_world(rank, world):
    """One rank of ``examples.graph_analytics`` as ``torchrun`` would start
    it (``WORLD_SIZE`` set; the group is the spawner's)."""
    import os

    from repro_torch.examples import graph_analytics

    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)
    return graph_analytics.main(["--device", "cpu", "--num-vertices",
                                 "1000", "--num-edges", "8000"])


def failing_entry(rank, world):
    """Rank 1 raises while rank 0 waits in a collective."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    mesh = RankMesh(device="cpu")
    mesh.all_reduce(torch.zeros(1))


def hanging_entry(rank, world):
    time.sleep(60)


def cuda_world(rank, world, graph, shards):
    """One rank of a world with CUDA tensors on the card: the fused and
    the host loop for sssp_bf and pagerank over a RankMesh, then (rank 0)
    the same at the single-process ``mesh=m``."""
    import torch.distributed as dist

    from repro_torch.kernels import edge_block as ebk

    mesh = RankMesh()  # cuda:{rank % device_count}
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "host_backend": str(dist.get_backend(mesh.cpu_group)),
           "ranks": {}, "single": {}, "launches": {}}
    for loop in ("fused", "host"):
        for prog_name in ("sssp_bf", "pagerank"):
            key = (loop, prog_name, "bsp")
            before = ebk.csr_tile.launches
            mw = middleware(graph, prog_name, loop, "bsp", shards, mesh, None)
            res = mw.run(max_iterations=max_it(prog_name))
            out["launches"][key] = ebk.csr_tile.launches - before
            out["ranks"][key] = _run_record(res)
            if rank == 0:
                mw = middleware(graph, prog_name, loop, "bsp", shards,
                                mesh.size, mesh.device)
                out["single"][key] = _run_record(
                    mw.run(max_iterations=max_it(prog_name)))
    return out


# --------------------------------------------------------------------------
# the async loop and structure epochs across ranks
# (tests/test_torch_ranks_async.py, tests/test_torch_ranks_epoch.py)
# --------------------------------------------------------------------------
ASYNC_ARMS = {"eager": dict(theta0=0.0, decay=0.5),
              "holding": dict(theta0=10.0, decay=0.9),
              "buckets": dict(theta0=10.0, decay=0.9, bucket_k=8)}
ASYNC_PROGRAMS = ("sssp_bf", "bfs", "wcc", "pagerank")


def _stripped(value):
    """A record without its wall-clock entries (``seconds``), which each
    rank measures for itself."""
    if isinstance(value, dict):
        return {k: _stripped(v) for k, v in value.items() if k != "seconds"}
    if isinstance(value, list):
        return [_stripped(v) for v in value]
    return value


def _epoch_record(res, mw) -> dict:
    out = _run_record(res)
    out["records"] = _stripped(out["records"])
    out["m"] = mw.upper.m
    out["epoch"] = (mw.epochs.version, mw.epochs.epoch.cause)
    out["last_restart"] = mw.last_restart
    out["loop"] = type(mw._loop).__name__
    # the survivor mesh the run ended on (one process: the whole axis)
    out["members"] = list(getattr(mw.ranks, "members", [0]))
    out["local"] = getattr(mw.ranks, "local", mw.upper.m)
    return out


def _model(name):
    return plug.AsyncModel(**ASYNC_ARMS[name]) if name in ASYNC_ARMS \
        else name


def fused_middleware(graph, prog_name, model, shards, mesh, device, **kw):
    """The fused composition of the async and epoch cases (``model`` a
    BSP/GAS name or an async arm), over a RankMesh or at an int m."""
    prog = talg.ALGORITHMS[prog_name](graph)
    daemon = plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                csr_config=CSRConfig())
    if not isinstance(mesh, RankMesh):
        kw["device"] = device
    return plug.Middleware(graph, prog, daemon=daemon,
                           upper=plug.MeshUpperSystem(mesh=mesh),
                           model=_model(model), num_shards=shards,
                           options=plug.PlugOptions(block_size=BLOCK), **kw)


def _async_case(graphs, key, shards, mesh):
    prog_name, arm = key
    mw = fused_middleware(_graph_for(graphs, prog_name), prog_name, arm,
                          shards, mesh, "cpu")
    if not isinstance(mw._loop, plug.AsyncDriveLoop):
        raise AssertionError(f"{key}: ran {type(mw._loop).__name__}")
    out = _run_record(mw.run(max_iterations=max_it(prog_name)))
    out["m"] = mw.upper.m
    return out


def async_world(rank, world, graphs, shards, local):
    """One rank of an async world: every program x arm over a RankMesh of
    ``world`` ranks × ``local`` devices, then this rank's share of the
    same cases at the single-process ``mesh=m``."""
    torch.set_num_threads(1)
    mesh = RankMesh(local=local, device="cpu")
    cases = [(p, a) for p in ASYNC_PROGRAMS for a in ASYNC_ARMS]
    out = {"rank": rank, "ranks": {}, "single": {}}
    for key in cases:
        out["ranks"][key] = _async_case(graphs, key, shards, mesh)
    for i, key in enumerate(cases):
        if i % world == rank:
            out["single"][key] = _async_case(graphs, key, shards, mesh.size)
    out["imports"] = sorted(
        name for name in sys.modules
        if name.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def _log(adds=(), removes=()):
    log = plug.MutationLog()
    for u, v in adds:
        log.add_edge(int(u), int(v), 1.0)
    for u, v in removes:
        log.remove_edge(int(u), int(v))
    return log


def epoch_cases(m: int) -> list:
    """``(name, program, model, schedule keywords)`` of the scheduled
    epoch cases at m devices: a kill of the last device, of device 1 (in a
    2 × 2 world the survivors are not one a rank), a kill and a join, a
    straggler's re-partition, each under GAS (a kill under BSP pagerank,
    a kill and a join under async holding too)."""
    slow = [(2, d, 8.0 if d == m - 2 else 1.0) for d in range(m)]
    return [("kill_last", "sssp_bf", "gas", dict(kills=[(2, m - 1)])),
            ("kill_last", "pagerank", "bsp", dict(kills=[(2, m - 1)])),
            ("kill_1", "sssp_bf", "gas", dict(kills=[(2, 1)])),
            ("kill_join", "sssp_bf", "gas",
             dict(kills=[(2, 1)], recoveries=[(4, 1)])),
            ("kill_join", "sssp_bf", "holding",
             dict(kills=[(2, 1)], recoveries=[(4, 1)])),
            ("straggler", "sssp_bf", "gas", dict(slow=slow))]


def _epoch_case(graphs, case, shards, mesh, mutations):
    """One epoch case on ``mesh`` → its runs' records (a case may run
    twice: once with the trigger, once after it)."""
    name, prog_name, model, sched = case
    g = _graph_for(graphs, prog_name)
    adds, removes = mutations
    runs = []
    if name == "host_dynamic":
        mw = middleware(g, prog_name, "host", model, shards, mesh, "cpu")
        runs.append(_epoch_record(mw.run(), mw))
        runs.append(_epoch_record(mw.run_dynamic(_log(adds)), mw))
        return runs
    kw = {}
    if sched:
        kw["failures"] = plug.FailureSchedule(**sched)
    if name.startswith("midrun"):
        kw["mutations"] = plug.MutationSchedule(events=[(2, _log(adds))])
    mw = fused_middleware(g, prog_name, model, shards, mesh, "cpu", **kw)
    runs.append(_epoch_record(mw.run(max_iterations=max_it(prog_name)), mw))
    if name == "rebalance":
        caps = np.ones(shards)
        caps[0] = 2.0  # shard 0 at half the others' capacity
        runs[-1]["fractions"] = [float(f) for f in mw.rebalance(caps)]
    elif name == "dynamic_add":
        runs.append(_epoch_record(mw.run_dynamic(_log(adds)), mw))
        return runs
    elif name == "dynamic_remove":
        runs.append(_epoch_record(mw.run_dynamic(_log(removes=removes)),
                                  mw))
        return runs
    # a second run on the structure the first one left (idle ranks sit it
    # out from its start)
    runs.append(_epoch_record(mw.run(max_iterations=max_it(prog_name)), mw))
    return runs


def all_epoch_cases(m: int) -> list:
    return epoch_cases(m) + [
        ("rebalance", "sssp_bf", "gas", None),
        ("dynamic_add", "sssp_bf", "gas", None),
        ("dynamic_remove", "sssp_bf", "gas", None),
        ("midrun_add", "sssp_bf", "gas", None),
        ("midrun_add", "sssp_bf", "holding", None),
        ("host_dynamic", "sssp_bf", "bsp", None)]


def epoch_world(rank, world, graphs, shards, local, mutations):
    """One rank of an epoch world: every case of :func:`all_epoch_cases`
    over a RankMesh of ``world`` ranks × ``local`` devices, then this
    rank's share of the same cases at the single-process ``mesh=m``, and
    the refusals' bad monitor and mutation schedule."""
    torch.set_num_threads(1)
    mesh = RankMesh(local=local, device="cpu")
    cases = all_epoch_cases(mesh.size)
    out = {"rank": rank, "ranks": {}, "single": {}}
    for case in cases:
        out["ranks"][case[:3]] = _epoch_case(graphs, case, shards, mesh,
                                             mutations)
    for i, case in enumerate(cases):
        if i % world == rank:
            out["single"][case[:3]] = _epoch_case(graphs, case, shards,
                                                  mesh.size, mutations)
    out["imports"] = sorted(
        name for name in sys.modules
        if name.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


# --------------------------------------------------------------------------
# out of core and graph serving across ranks
# (tests/test_torch_ranks_oocore.py, tests/test_torch_ranks_serve.py)
# --------------------------------------------------------------------------
# the bit-identity matrix: hot fraction x groups x prefetch
OOCORE_MATRIX = [(hot, groups, prefetch) for hot in (0.0, 0.25)
                 for groups in (2, 3) for prefetch in (True, False)]
OOCORE_KERNELS = ("reference", "cuda")
# a graph with several columns a shard for each body: blocks of BLOCK
# edges for the block body, tiles of 512 for the CSR body
OOCORE_GRAPH = {"reference": "directed", "cuda": "dense"}
# the per-iteration counters of an out-of-core record, but the rank's own
# copies and spans (``skipped`` is the rank's too: a rank may skip more)
OOCORE_COUNTERS = ("super_shards", "hot_cols", "prefetch", "skipped",
                   "hot_hits", "cold_misses")
ROAD_ITERATIONS = 10
FETCHES = ("cpu", "tolist", "item", "__bool__", "__int__")


def oocore_cases() -> list:
    """``(name, kernel, program, oocore keywords)``: the matrix for both
    bodies (sssp_bf GAS), a byte budget, a kill of the last device then a
    re-plan at half the budget, pagerank, the road network's skips, and an
    unpinned CSR config out of core and resident.  ``"budget"`` in the
    keywords is a share of the resident column bytes the parent hands the
    world (``budgets``)."""
    cases = [(("matrix", hot, groups, prefetch), kernel, "sssp_bf",
              dict(num_super_shards=groups, hot_fraction=hot,
                   prefetch=prefetch))
             for kernel in OOCORE_KERNELS
             for hot, groups, prefetch in OOCORE_MATRIX]
    for kernel in OOCORE_KERNELS:
        cases += [(("budget",), kernel, "sssp_bf",
                   dict(budget=3, hot_fraction=0.25)),
                  (("kill",), kernel, "sssp_bf",
                   dict(budget=3, hot_fraction=0.3)),
                  (("pagerank",), kernel, "pagerank",
                   dict(num_super_shards=3, hot_fraction=0.25))]
    return cases + [
        (("road",), "reference", "sssp_bf",
         dict(num_super_shards=6, hot_fraction=0.0)),
        (("autotune",), "cuda", "sssp_bf",
         dict(num_super_shards=2, hot_fraction=0.25)),
        (("autotune", "resident"), "cuda", "sssp_bf", None)]


def oocore_graph(name, kernel) -> str:
    """The graph a case runs on."""
    return "road" if name[0] == "road" else OOCORE_GRAPH[kernel]


def oocore_config(oc, budget):
    """The case's ``OocoreConfig``: ``budget=d`` is the resident column
    bytes per logical device over d."""
    if oc is None:
        return None
    oc = dict(oc)
    if "budget" in oc:
        oc["hbm_budget"] = budget // oc.pop("budget")
    return plug.OocoreConfig(**oc)


def oocore_middleware(graph, prog_name, kernel, shards, mesh, oocore,
                      csr_config=CSRConfig(), **kw):
    """``prog_name`` under GAS (a sum program under BSP) out of core (or
    resident with ``oocore=None``), over a RankMesh or at an int m."""
    prog = talg.ALGORITHMS[prog_name](graph)
    if not isinstance(mesh, RankMesh):
        kw["device"] = "cpu"
    return plug.Middleware(
        graph, prog, daemon=plug.ShardedDaemon(kernel=kernel, mesh=mesh,
                                               csr_config=csr_config),
        upper=plug.MeshUpperSystem(mesh=mesh),
        model="bsp" if prog_name in SUM_PROGRAMS else "gas",
        num_shards=shards, oocore=oocore,
        options=plug.PlugOptions(block_size=BLOCK), **kw)


class counting_fetches:
    """Records ``(method, numel)`` of every device→host read a block makes
    through the tensor methods in FETCHES."""

    def __init__(self):
        self.calls = []
        self._saved = {}

    def __enter__(self):
        for name in FETCHES:
            orig = self._saved[name] = getattr(torch.Tensor, name)

            def wrapper(t, *a, _n=name, _o=orig, **kw):
                self.calls.append((_n, t.numel()))
                return _o(t, *a, **kw)

            setattr(torch.Tensor, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(torch.Tensor, name, orig)


def recording_verdicts(mw) -> list:
    """Appends, before each out-of-core step, the groups the step skips
    (None when it takes every group)."""
    verdicts = []
    loop = mw._loop
    advance = loop._advance

    def recorded(carry, aux, it, stacked):
        act = loop._activity
        verdicts.append(None if act is None else
                        [g for g, a in enumerate(act) if not a])
        return advance(carry, aux, it, stacked)

    loop._advance = recorded
    return verdicts


def _oocore_record(res, mw, verdicts, fetches) -> dict:
    import dataclasses

    out = _epoch_record(res, mw)
    recs = res.per_iteration
    out["records"] = _stripped([
        {k: v for k, v in r.items() if k != "oocore"} for r in recs])
    out["counters"] = [{k: r["oocore"][k] for k in OOCORE_COUNTERS}
                       for r in recs if "oocore" in r]
    plan = mw.daemon.oocore_plan
    out["plan"] = None if plan is None else dataclasses.asdict(plan)
    out["verdicts"] = list(verdicts)
    out["groups_held"] = len(mw.daemon._cold)
    out["hot_held"] = mw.daemon.hot_stacked is not None
    up = getattr(mw._loop, "_uploader", None)
    out["max_live_groups"] = 0 if up is None else up.max_live_groups
    out["slots"] = 0 if up is None else up.slot_allocations
    out["fetches"] = fetches
    return out


def _oocore_case(graphs, case, shards, mesh, budgets) -> list:
    """One out-of-core case on ``mesh`` → its runs' records (the kill
    case runs twice: under the kill, then after a re-plan at half the
    budget)."""
    from repro_torch.kernels import autotune

    name, kernel, prog_name, oc = case
    g = graphs[oocore_graph(name, kernel)]
    budget = budgets[kernel]
    kw = {}
    if name == ("kill",):
        m = mesh.size if isinstance(mesh, RankMesh) else mesh
        kw["failures"] = plug.FailureSchedule(kills=[(3, m - 1)])
    autotune.CACHE.clear()
    mw = oocore_middleware(
        g, prog_name, kernel, shards, mesh, oocore_config(oc, budget),
        csr_config=None if name[0] == "autotune" else CSRConfig(), **kw)
    if oc is not None and not isinstance(mw._loop, plug.OocoreDriveLoop):
        raise AssertionError(f"{name}: ran {type(mw._loop).__name__}")
    cap = ROAD_ITERATIONS if name == ("road",) else max_it(prog_name)

    def run():
        verdicts = (recording_verdicts(mw) if oc is not None
                    else [])
        with counting_fetches() as f:
            res = mw.run(max_iterations=cap)
        vars(mw._loop).pop("_advance", None)
        return _oocore_record(res, mw, verdicts, f.calls)

    runs = [run()]
    runs[0]["sweeps"] = autotune.CACHE.sweeps
    runs[0]["config"] = mw.daemon._csr_config
    if name == ("kill",):
        ep = mw.oocore_replan(oocore_config(dict(oc, budget=6), budget))
        runs.append(run())
        runs[-1]["replan"] = {k: v for k, v in ep.meta.items()
                              if k not in ("seconds", "oocore_config")}
    return runs


def oocore_world(rank, world, graphs, shards, local, budgets):
    """One rank of an out-of-core world: every case of
    :func:`oocore_cases` over a RankMesh of ``world`` ranks × ``local``
    devices, then this rank's share of the same cases at ``mesh=m``."""
    torch.set_num_threads(1)
    mesh = RankMesh(local=local, device="cpu")
    cases = oocore_cases()
    out = {"rank": rank, "ranks": {}, "single": {}}
    for case in cases:
        out["ranks"][case[:2]] = _oocore_case(graphs, case, shards, mesh,
                                              budgets)
    for i, case in enumerate(cases):
        if i % world == rank:
            out["single"][case[:2]] = _oocore_case(graphs, case, shards,
                                                   mesh.size, budgets)
    out["imports"] = sorted(
        name for name in sys.modules
        if name.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


SERVE_SEEDS = [3, 17, 17, (5, 9)]
SERVE_PARAMS = {"khop": (("hops", 2),), "sssp": (), "ppr": ()}
SERVE_LOOKUPS = [(3,), (5, 9)]
SERVE_REQUESTS = 40
SERVE_RATE = 400.0
SERVE_KILL = dict(kills=[(5, 1)], recoveries=[(8, 1)])
SERVE_MUTATION = [(3, 200, 0.5), (200, 41, 0.5)]
SERVE_AFTER = [("sssp", 5, {}), ("lookup", 3, {"field": "pagerank"})]


def _values(xs) -> list:
    return [np.asarray(x) for x in xs]


def _recording(session) -> list:
    """Appends each ``execute_batch`` call's (kind, params, seeds) to the
    returned list."""
    calls = []
    run = session.execute_batch

    def recorded(kind, params, seeds_list):
        calls.append((kind, params, [tuple(int(v) for v in np.atleast_1d(s))
                                     for s in seeds_list]))
        return run(kind, params, seeds_list)

    session.execute_batch = recorded
    return calls


def _answered(router, query):
    ticket, ans = router.submit(query)
    if ans is None:
        router.drain()
        ans = router.result(ticket)
    return ans


def serve_script(serve, make_session, make_log, make_failures) -> dict:
    """One package's serving run, answers and records but service times:
    a batch of each kind, both lookup fields, a seeded replay through the
    router (its batches recorded) and a mutation through
    ``GraphServeRouter.mutate`` on that session; then on a session with a
    monitor (``make_failures()`` → (monitor, schedule)) a kill and a join
    mid-serve.  ``serve`` is ``repro_torch.serve`` or the JAX package's;
    ``make_session(**kw)`` builds a session, ``make_log(edges)`` a
    mutation log.  Imports nothing itself."""
    session = make_session()
    out = {"batches": {}, "lookups": {}}
    for kind, params in SERVE_PARAMS.items():
        answers, rec = session.execute_batch(kind, params, SERVE_SEEDS)
        out["batches"][kind] = (_values(answers), {
            k: rec[k] for k in ("batch", "bucket", "iterations", "converged",
                                "durable", "mesh_epoch")})
    for field in ("pagerank", "wcc"):
        answers, _ = session.execute_batch("lookup", (("field", field),),
                                           SERVE_LOOKUPS)
        out["lookups"][field] = _values(answers)
    wl = serve.generate_workload(
        num_requests=SERVE_REQUESTS, num_vertices=session.graph.num_vertices,
        rate=SERVE_RATE, seed=0, hops=2, repeat_fraction=0.2)
    calls = _recording(session)
    router = serve.GraphServeRouter(session, max_batch=session.max_batch)
    answers, stats = serve.replay(router, wl)
    out["replay"] = {
        "calls": list(calls),
        "answers": [(a.query.cache_key, a.cached, a.batch, a.iterations,
                     np.asarray(a.value)) for a in answers],
        "completed": stats["completed"], "cached": stats["cached"]}
    rec = router.mutate(make_log(SERVE_MUTATION))
    out["mutate"] = {"record": rec, "after": [
        (kind, bool(ans.cached), np.asarray(ans.value))
        for kind, seed, kw in SERVE_AFTER
        for ans in [_answered(router, serve.Query.make(kind, seed, **kw))]]}
    out["families"] = sorted(session.compiled_families)
    # the port's construction seconds, by family (JAX's session keeps none)
    out["init_keys"] = sorted(getattr(session, "init_s", {}), key=repr)

    # a kill and a join mid-serve (tests/test_serve.py's scenario)
    monitor, failures = make_failures()
    session = make_session(monitor=monitor, failures=failures)
    router = serve.GraphServeRouter(session, max_wait=0.0)
    khop = serve.Query.make("khop", 3, hops=2)
    t_warm, _ = router.submit(khop)
    router.clock.advance(0.01)
    router.pump()
    warm = router.result(t_warm)
    router.cache.insert(("sentinel",), 0, durable=False)
    t_ppr, _ = router.submit(serve.Query.make("ppr", 7))
    router.clock.advance(0.01)
    router.pump()
    hit = router.submit(khop)[1]
    answers, rec = session.execute_batch("sssp", (), [3, (5, 9)])
    out["kill"] = {
        "epoch": session.mesh_epoch,
        "ppr_m": session._family("ppr", (), 1)["mw"].daemon.m,
        "sentinel": ("sentinel",) in router.cache,
        "flushed": router.cache.stats.flushed,
        "khop_kept": khop.cache_key in router.cache,
        "hit": hit is not None and hit.cached,
        "warm": np.asarray(warm.value),
        "ppr": np.asarray(router.result(t_ppr).value),
        "sssp": _values(answers), "after_epoch": rec["mesh_epoch"],
        "after_migrations": len(rec["migrations"])}
    return out


def serve_world(rank, world, graph, shards, local):
    """One rank of a serving world: :func:`serve_script` over a RankMesh
    of ``world`` ranks × ``local`` devices (kernel="cuda", its plain twin
    at ``CSRConfig()``), then on rank 0 the same at ``mesh=m``."""
    from repro_torch import serve

    torch.set_num_threads(1)
    mesh = RankMesh(local=local, device="cpu")
    m = mesh.size

    def script(at):
        kw = {} if isinstance(at, RankMesh) else {"device": "cpu"}

        def make_session(**extra):
            return serve.GraphServeSession(
                graph, num_shards=shards, kernel="cuda", max_batch=8,
                block_size=BLOCK, csr_config=CSRConfig(), mesh=at,
                **kw, **extra)

        def failures():
            return (plug.FleetMonitor(num_hosts=m),
                    plug.FailureSchedule(**SERVE_KILL))

        return serve_script(serve, make_session, _serve_log, failures)

    out = {"rank": rank, "ranks": script(mesh)}
    if rank == 0:
        out["single"] = script(m)
    out["imports"] = sorted(
        name for name in sys.modules
        if name.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def _serve_log(edges):
    log = plug.MutationLog()
    for u, v, w in edges:
        log.add_edge(u, v, w)
    return log


def graph_serve_world(rank, world, argv):
    """One rank of ``launch.graph_serve`` as ``torchrun`` would start it
    (``WORLD_SIZE`` set; the group is the spawner's) → its replay's counts
    and every answer."""
    import os

    from repro_torch.launch import graph_serve

    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)
    return launcher_answers(graph_serve, argv)


def launcher_answers(graph_serve, argv):
    """``graph_serve.main(argv)`` with its replay's answers recorded →
    ((completed, cached), [(cache key, cached, value)])."""
    got = []
    replay = graph_serve.replay

    def recorded(router, wl):
        answers, stats = replay(router, wl)
        got.extend((a.query.cache_key, a.cached, np.asarray(a.value))
                   for a in answers)
        return answers, stats

    graph_serve.replay = recorded
    try:
        stats = graph_serve.main(argv)
    finally:
        graph_serve.replay = replay
    return (stats["completed"], stats["cached"]), got


def cuda_oocore_world(rank, world, graph, shards, oocore):
    """One rank of an out-of-core world on the card: sssp_bf GAS over a
    RankMesh (``cuda:{rank % device_count}``) with ``oocore`` (keywords of
    ``OocoreConfig``), then (rank 0) the same at ``mesh=world``.  Reports
    each run, the rank's side stream and slots, and csr_tile's launches
    against (hot > 0) + uploads a step."""
    from repro_torch.kernels import edge_block as ebk

    mesh = RankMesh()

    def run(at):
        kw = {} if isinstance(at, RankMesh) else {"device": mesh.device}
        mw = plug.Middleware(
            graph, talg.sssp_bf(graph), daemon=plug.ShardedDaemon(
                kernel="cuda", mesh=at, csr_config=CSRConfig()),
            upper=plug.MeshUpperSystem(mesh=at), model="gas",
            num_shards=shards, oocore=plug.OocoreConfig(**oocore),
            options=plug.PlugOptions(block_size=BLOCK), **kw)
        before = ebk.csr_tile.launches
        res = mw.run()
        recs = [r["oocore"] for r in res.per_iteration]
        up = mw._loop._uploader
        return {"state": np.asarray(res.state),
                "iterations": res.iterations,
                "counters": [{k: r[k] for k in OOCORE_COUNTERS}
                             for r in recs],
                "launches": ebk.csr_tile.launches - before,
                "want_launches": sum(int(r["hot_cols"] > 0)
                                     + r["super_shards"] - r["skipped"]
                                     for r in recs),
                "side_stream": mw._loop._side is not None,
                "slots": up.slot_allocations,
                "max_live_groups": up.max_live_groups,
                "uploads": sum(r["super_shards"] - r["skipped"]
                               for r in recs)}

    out = {"device": str(mesh.device), "ranks": run(mesh)}
    if rank == 0:
        out["single"] = run(mesh.size)
    return out
