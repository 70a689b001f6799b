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
        "oocore": lambda: mw(oocore=plug.OocoreConfig(num_super_shards=2)),
        "bad_monitor": lambda: mw(monitor=object()),
        "bad_mutations": lambda: mw(mutations=object()).run(),
        "migrate_without_monitor": run_built("migrate"),
        "serve": lambda: _serve_session(g, shards, mesh),
        "moe": lambda: _moe_under(mesh),
        "super_shards": lambda: plug.ShardedDaemon(mesh=mesh).bind(
            prog, g.num_vertices, device="cpu").bind_super_shards(
                mw(daemon="reference").blocksets,
                config=plug.OocoreConfig(num_super_shards=2)),
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


def _serve_session(g, shards, mesh):
    from repro_torch.serve import GraphServeSession

    return GraphServeSession(g, num_shards=shards, mesh=mesh, device="cpu")


def _moe_under(mesh):
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe

    cfg = get_reduced("qwen3-moe-235b-a22b")
    with shd.activation_sharding(mesh, {}):
        return moe.moe_ffn({}, torch.zeros(1, 2, cfg.d_model), cfg)


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
