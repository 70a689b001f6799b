"""The MoE's expert layout across ``torch.distributed`` ranks on the CPU:
``models/moe.py::moe_ffn`` over a ``dist.sharding.RankGrid`` of gloo ranks
against the JAX package's ``_moe_shardmap`` on an 8-device host mesh.

Three worlds, each spawned once for the module (``launch.mesh.spawn_ranks``,
``file://`` rendezvous under a temporary directory): (data, model) grids
(2, 2), (4, 2) and (1, 4).  The JAX oracle runs meanwhile in a subprocess
(tests/jax_mesh_oracle.py), which asks XLA for 8 host devices before it
imports ``jax`` and lays them out with Auto axes.  The cases
(tests/torch_model_ranks.py's ``MOE_CASES``): reduced qwen3-moe (top-2)
and llama4-scout (top-1 and the shared expert) with the batch's rows split
over data; the rows held whole with dp | t (each data rank a block of the
tokens); the ``t % dp`` fallback; the ``e % mp`` fallback (3 experts on a
model axis of 2) with the rows split and whole.  ``capacity_factor`` 0.5
on both sides, so assignments drop per shard.

Held within 1e-5 · max |want|: each rank's output rows, the aux loss, the
gradients of x (its rows), the router, the experts' blocks (wi, wg, wo)
and the shared expert (summed over data where the rows are split), and
the dropped assignments exactly.  A gradient leaf is held within twice
JAX's own float32 distance from the float64 value of the same layout
(``torch_model_ranks.moe_grads_f64``) where that is the larger: top-1
routing's gate normalisation g / Σg has a gradient that is zero in exact
arithmetic and float32 rounding noise in both packages, so llama4-scout's
router gradient lies 3.2e-5 · max |want| from its float64 value in JAX
(3.6e-5 in the port) — no float32 result can be held to JAX within
1e-5 · max |want| there.  Every other leaf is held to 1e-5; JAX's leaves
lie within 1e-4 · max of the float64 values, so these are the layout's.
Where the tokens are sharded, JAX's result differs from its local path,
so the layout is what is held.  The
init's blocks are bit-equal to the one-process init's (tests/
test_torch_ranks_train.py holds the whole model's).
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import torch_model_ranks as W
from repro_torch.launch.mesh import spawn_ranks

TOL = 1e-5
# JAX's float32 gradients against the float64 value of the same layout
FLOOR_CAP = 1e-4
WORLD_TIMEOUT_S = 300.0
HERE = os.path.dirname(os.path.abspath(__file__))


def _oracle(mode, dest, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_mesh_oracle.py"), mode,
         str(dest), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _collect(proc, dest, timeout):
    log, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, log
    with open(dest, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ranks")
    oracle = _oracle("moe", tmp / "moe.pkl")
    try:
        with concurrent.futures.ThreadPoolExecutor(len(W.MOE_GRIDS)) as ex:
            futures = {}
            for name, (dp, mp) in W.MOE_GRIDS.items():
                cases = [c for c, v in W.MOE_CASES.items()
                         if v[1] == (dp, mp)]
                futures[name] = ex.submit(
                    spawn_ranks, W.moe_world, dp * mp, (mp, cases),
                    backend="gloo", init_method=f"file://{tmp}/{name}",
                    timeout_s=WORLD_TIMEOUT_S)
            ranks = {name: f.result() for name, f in futures.items()}
        want = _collect(oracle, tmp / "moe.pkl", WORLD_TIMEOUT_S)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    return ranks, want


def _close(got, want, what, exact=None):
    """|got − want| ≤ 1e-5 · max |want|, or, where ``exact`` (the float64
    value) is given and JAX's float32 ``want`` is farther from it than
    that, ≤ twice that distance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    tol = TOL * scale
    if exact is not None and want.size:
        tol = max(tol, 2.0 * float(np.abs(want - exact).max()))
    assert err <= tol, f"{what}: {err} > {tol} (1e-5 · {scale})"


def _world(case):
    dp, mp = W.MOE_CASES[case][1]
    return f"{dp}x{mp}"


@pytest.mark.parametrize("case", sorted(W.MOE_CASES))
def test_moe_ffn_across_ranks_matches_jax(runs, case):
    ranks, want = runs
    w = want[case]
    exact = W.moe_grads_f64(case, w["sharded"])
    top1 = W.moe_cfg(case).experts_per_token == 1
    for name, g in w["grads"].items():
        # the float64 value is the layout's: JAX lies near it everywhere
        err = float(np.abs(g - exact[name]).max())
        assert err <= FLOOR_CAP * float(np.abs(g).max()), (case, name, err)
    for r in ranks[_world(case)]:
        got = r["cases"][case]
        rows = got["rows"]
        where = f"{case} rank {r['rank']}"
        _close(got["out"], w["out"][rows], f"{where} out")
        assert abs(got["aux"] - w["aux"]) <= TOL * abs(w["aux"]), where
        assert got["stats"] == w["stats"], (where, got["stats"], w["stats"])
        _close(got["grads"]["x"], w["grads"]["x"][rows], f"{where} dx")
        for name, g in got["grads"].items():
            if name == "x":
                continue
            full = w["grads"][name]
            block = got["slices"].get(name)
            sl = (lambda a: a) if block is None else (lambda a: a[block])
            # only top-1 routing's router gradient is float32 noise of a
            # value zero in exact arithmetic: there JAX's own distance
            # from the float64 value bounds the port's
            _close(g, sl(full), f"{where} d{name}",
                   sl(exact[name]) if top1 and name == "router" else None)


@pytest.mark.parametrize("case", [c for c in sorted(W.MOE_CASES)
                                  if "/rows" in c or "/blocks" in c
                                  if "e3" not in c and "1x4" not in c])
def test_sharded_tokens_differ_from_the_local_path(runs, case):
    """With the tokens sharded over data, each shard drops what its own
    capacity cannot hold: JAX's layout and its local path differ there,
    so the ranks are held to the layout, not to the local path."""
    _, want = runs
    w = want[case]
    assert w["sharded"]
    assert float(np.abs(w["out"] - w["local_out"]).max()) > 1e-3


@pytest.mark.parametrize("world", sorted(W.MOE_GRIDS))
def test_experts_live_on_the_model_axis(runs, world):
    """Rank (d, r) holds experts [r·E/mp, (r+1)·E/mp) of wi, wg, wo (the
    whole of them where mp does not divide E); every leaf — the router and
    the shared expert too — has the JAX rules' spec for the grid (the
    router's FSDP dim on data where dp > 1); the ranks are row-major, as
    jax.make_mesh lays out devices; no rank imported the JAX package."""
    ranks, _ = runs
    dp, mp = W.MOE_GRIDS[world]
    for r in ranks[world]:
        assert r["coords"] == {"data": r["rank"] // mp,
                               "model": r["rank"] % mp}
        assert r["imports"] == []
        for case, got in r["cases"].items():
            cfg = W.moe_cfg(case)
            e = cfg.num_experts
            for name in ("wi", "wg", "wo"):
                shape = got["local_shapes"][name]
                if e % mp:
                    assert got["slices"].get(name, (slice(None),))[0] \
                        == slice(None)
                    assert shape[0] == e
                    continue
                lo = (r["rank"] % mp) * (e // mp)
                assert got["slices"][name][0] == slice(lo, lo + e // mp)
                assert shape[0] == e // mp
            assert got["specs"] == got["jax_specs"], case
            assert got["specs"]["router"] == ("data",), case
