"""Mesh construction, as in the JAX package's ``launch/mesh.py``.

* :func:`make_host_mesh` — a model runs whole on one card, so the host mesh
  is a (data=1, model=1) shape-only mesh: ``dist.sharding``'s rules resolve
  against it and every spec replicates.
* :func:`make_rank_mesh` — the graph path's shard axis across the ranks
  ``torchrun`` started (``dist.sharding.RankMesh``).
* :func:`make_rank_grid` — the model path's (data, model) mesh across the
  same ranks (``dist.sharding.RankGrid``), sized as the JAX package's
  ``make_host_mesh`` sizes its mesh over the host's devices.
* :func:`spawn_ranks` — W ranks spawned from one process, each joining a
  process group of the caller's backend and running an entry function; a
  rank's exception or a rank past the time limit fails the caller.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback

from repro_torch.dist.sharding import RankGrid, RankMesh

COLLECTIVE_TIMEOUT_S = 60.0


class HostMesh:
    """Axis names and sizes, what ``dist.sharding`` reads of a mesh."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def make_host_mesh() -> HostMesh:
    """The one card as a (data, model) mesh of size 1."""
    return HostMesh(data=1, model=1)


def world_size() -> int:
    """The ranks ``torchrun`` started (``WORLD_SIZE``), 1 outside it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_rank_mesh(backend: str | None = None, *, device=None) -> RankMesh:
    """A :class:`~repro_torch.dist.sharding.RankMesh` (one logical device a
    rank) over the default group.  Unless a group is initialized already,
    it is initialized from the ``torchrun`` environment (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with
    ``backend``, which the caller names: ``"gloo"`` for several ranks on
    one card, ``"nccl"`` for one card a rank.  A collective waits at most
    ``COLLECTIVE_TIMEOUT_S``."""
    import torch

    _init_group(backend)
    mesh = RankMesh(device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def _init_group(backend: str | None) -> None:
    """Initializes the default group from the ``torchrun`` environment
    unless one is initialized already."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if backend is None:
            raise ValueError("no process group is initialized: name its "
                             "backend ('gloo' or 'nccl')")
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def default_model_parallel(world: int) -> int:
    """The JAX package's ``make_host_mesh`` default: 2 when the world is
    even and larger than 1, else 1."""
    return 2 if world % 2 == 0 and world > 1 else 1


def make_rank_grid(model_parallel: int | None = None, backend: str | None
                   = None, *, device=None, strategy: str = "2d") -> RankGrid:
    """A :class:`~repro_torch.dist.sharding.RankGrid` of the world's ranks,
    (W // mp, mp) over ("data", "model"), under ``strategy``'s rules;
    ``mp`` defaults to :func:`default_model_parallel`.  Unless a group is initialized already
    (``spawn_ranks``), it is initialized from the ``torchrun`` environment
    with ``backend``, as :func:`make_rank_mesh` does."""
    import torch
    import torch.distributed as dist

    _init_group(backend)
    mp_ = (default_model_parallel(dist.get_world_size())
           if model_parallel is None else model_parallel)
    grid = RankGrid(mp_, device=device, strategy=strategy)
    if grid.device.type == "cuda":
        torch.cuda.set_device(grid.device)
    return grid


def _rank_main(entry, rank, world, backend, init_method, args, results):
    """A spawned rank: joins the group, runs ``entry(rank, world, *args)``
    and puts ``(rank, ok, value or traceback)`` on ``results``."""
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        results.put((rank, True, entry(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
        # in the pipe before the group (and its sockets) goes, so the
        # parent reads this cause before a peer's broken collective
        results.close()
        results.join_thread()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(entry, world: int, args: tuple = (), *, backend: str,
                init_method: str, timeout_s: float = 120.0) -> list:
    """Runs ``entry(rank, world, *args)`` in ``world`` spawned processes
    joined in one process group (``backend``, ``init_method``, e.g. a
    ``file://`` path no other world uses) → the entries' return values in
    rank order.

    ``entry`` must be importable by the children (a module-level function)
    and its values picklable.  The first rank to raise fails the call with
    its traceback, as does a rank that dies without a word or a world not
    done within ``timeout_s``; a collective waits at most
    ``COLLECTIVE_TIMEOUT_S``.  Every process is gone when this returns or
    raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(entry, r, world, backend, init_method, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" not done within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world)]
