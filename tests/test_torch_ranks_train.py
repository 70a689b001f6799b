"""Training across ``torch.distributed`` ranks on the CPU: the train step on
a ``dist.sharding.RankGrid`` of gloo ranks, and ``launch.train
--kill-device-at`` across them, against the JAX package's jitted
``make_train_step`` on an 8-device host mesh with Auto axes.

Two worlds, each spawned once for the module: (data, model) grids (2, 2)
and (4, 2).  Each runs 3 steps of B=8 × 16 tokens with ``microbatches=2``
for reduced qwen3-moe, llama4-scout and stablelm in float32, from the
port's init at the seed (a rank draws the one-process init and keeps its
block); the (2, 2) world also returns its init and ``convert`` blocks and
runs ``launch.train --kill-device-at 2`` (qwen3-moe, 5 steps): at step 2
the grid loses rank 3 and goes on as (1, 2) on ranks 0-1.  The JAX side
runs meanwhile in three subprocesses (tests/jax_mesh_oracle.py): the steps
on each mesh, and the kill through the package's own
``launch.train.remesh_live_state`` onto the first 3 devices.

Held: every rank's losses and ``grad_norm`` within 1e-5 of JAX's
(relative) and of each other; the parameters after the steps within
1e-5 · max |want| of each leaf's block (after the kill, on the survivors;
the idle ranks return the leader's losses), except at the elements whose
gradient was float32 noise in the same step in both packages (0 < |g| ≤
1e-5 of the leaf's max in the rank's gradient and in JAX's, which the
oracle exports: ``NOISE``), where Adam's normalisation turns a last-bit
gradient difference into a move of up to lr, and at stablelm's key bias,
whose gradient is zero in exact arithmetic — there within ``NOISE_MOVE``,
about 4× the largest such move read on sound runs; the init's blocks
bit-equal to
the one-process init's, and ``convert.model_params_from_jax(mesh=grid)``
the same blocks; every leaf laid out as the JAX rules say (FSDP on data,
TENSOR, HEADS, KV_HEADS, VOCAB and EXPERT on model, the divisibility
fallback included); ``--checkpoint-dir`` and ``--grad-wire`` across ranks
refused, naming ROADMAP items 13d.8 and 13d.9.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_model_ranks as W
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import Model
from test_torch_ranks_moe import _collect, _oracle

TOL = 1e-5
# Adam moves a parameter by lr·m̂ / (√v̂ + eps): a gradient error δ at an
# element of gradient g moves it by up to lr·δ/|g| a step.  An element
# whose gradient is within NOISE of its leaf's max in the same step in
# both packages, where float32 sums over the tokens carry errors of that
# order, is held within NOISE_MOVE: about 4× the largest such move these
# runs read on the CPU (4.7e-5 at top-1 routing's router in the (2, 2)
# world, 1.9e-5 elsewhere; Adam's own bound, 2·lr a step, is 6e-3).
NOISE = 1e-5
NOISE_MOVE = 2e-4
# top-1 routing's router gradient carries float32 noise of 3.6e-5 of its
# max in either package (the gate g / Σg is 1, its gradient zero in exact
# arithmetic: tests/test_torch_ranks_moe.py), which moves an element at
# 1% of the max by 3.6e-3·lr a step, past 1e-5 of the leaf: there the
# share is 1e-2
NOISE_TOP1_ROUTER = 1e-2
# a leaf whose gradient is zero in exact arithmetic: the key bias (q·b_k is
# the same for every key of a query, and softmax ignores it), so every
# element is float32 noise and every move Adam's on noise, in either package
ZERO_GRADIENT = (".attn.bk",)
WORLD_TIMEOUT_S = 400.0
CASES = [(g, a) for g in W.TRAIN_GRIDS for a in W.TRAIN_ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ranks")
    oracles = {name: _oracle(*args) for name, args in (
        ("train 2x2", ("train", tmp / "t22.pkl", "2x2")),
        ("train 4x2", ("train", tmp / "t42.pkl", "4x2")),
        ("kill", ("kill", tmp / "kill.pkl")))}
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futures = {name: ex.submit(
                spawn_ranks, W.train_world, dp * mp,
                (mp, list(W.TRAIN_ARCHS), name == "2x2"), backend="gloo",
                init_method=f"file://{tmp}/{name}",
                timeout_s=WORLD_TIMEOUT_S)
                for name, (dp, mp) in W.TRAIN_GRIDS.items()}
            ranks = {name: f.result() for name, f in futures.items()}
        want = {**_collect(oracles["train 2x2"], tmp / "t22.pkl",
                           WORLD_TIMEOUT_S),
                **_collect(oracles["train 4x2"], tmp / "t42.pkl",
                           WORLD_TIMEOUT_S),
                "kill": _collect(oracles["kill"], tmp / "kill.pkl",
                                 WORLD_TIMEOUT_S)}
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ranks, want


def _rel(got, want):
    return abs(got - want) / abs(want)


def _noise(g, share):
    """The elements of a gradient that are nonzero and at most ``share`` of
    its max |g|."""
    a = np.abs(g)
    return (a > 0) & (a <= share * a.max())


def _params_close(got: dict, slices: dict, want: dict, what: str,
                  grads=(), jax_grads=(), top1=False, grad_slices=None):
    """Each leaf's block within 1e-5 · max |want|, except at the elements
    whose gradient was float32 noise in the same step in both packages
    (``_noise`` at NOISE of the leaf's max in the rank's gradient and in
    JAX's; ``top1``: NOISE_TOP1_ROUTER for top-1 routing's router) and in
    the leaves whose gradient is zero in exact arithmetic (ZERO_GRADIENT):
    those are held within NOISE_MOVE.  ``grad_slices``: each step's blocks
    where the layout changed between the steps (a kill's re-lay)."""
    assert set(got) == set(want), what
    assert len(grads) == len(jax_grads), what
    for k, full in want.items():
        sl = slices.get(k)

        def cut(a):
            return a if sl is None else a[sl]

        block = cut(full)
        scale = float(np.abs(block).max())
        diff = np.abs(got[k] - block)
        share = NOISE_TOP1_ROUTER if top1 and k.endswith(".router") \
            else NOISE
        noisy = np.full(diff.shape, k.endswith(ZERO_GRADIENT))
        for i, (g, jg) in enumerate(zip(grads, jax_grads)):
            gs = sl if grad_slices is None else grad_slices[i].get(k)
            idx = (slice(None),) * full.ndim if gs is None else gs
            step = np.zeros(full.shape, dtype=bool)
            step[idx] = _noise(g[k], share) & _noise(jg[k][idx], share)
            noisy |= cut(step)
        err = float(diff[~noisy].max()) if (~noisy).any() else 0.0
        assert err <= TOL * scale, f"{what} {k}: {err} > {TOL} · {scale}"
        if noisy.any():
            moved = float(diff[noisy].max())
            assert moved <= NOISE_MOVE, (what, k, moved, NOISE_MOVE)


@pytest.mark.parametrize("grid, arch", CASES,
                         ids=[f"{g}-{a}" for g, a in CASES])
def test_train_steps_match_jax(runs, grid, arch):
    ranks, want = runs
    w = want[grid, arch]
    first = ranks[grid][0]["train"][arch]
    for r in ranks[grid]:
        got = r["train"][arch]
        where = f"{grid} {arch} rank {r['rank']}"
        assert got["losses"] == first["losses"], where
        for a, b in zip(got["losses"], w["losses"]):
            assert _rel(a, b) <= TOL, (where, got["losses"], w["losses"])
        for a, b in zip(got["grad_norms"], w["grad_norms"]):
            assert _rel(a, b) <= TOL, (where, got["grad_norms"],
                                       w["grad_norms"])
        _params_close(got["params"], got["slices"], w["params"], where,
                      got["grads"], w["grads"],
                      W.train_cfg(arch).experts_per_token == 1)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_init_blocks_equal_the_one_process_init(runs, arch):
    """A rank's init from the seed is its block of the one-process init,
    bit for bit, under the JAX rules' spec of every leaf: FSDP on data,
    heads, the FFN's hidden dim, the vocabulary and the experts on
    model."""
    ranks, _ = runs
    cfg = W.get_reduced(arch)
    full = Model(cfg, device="cpu").init(torch.Generator().manual_seed(
        W.SEED)).state_dict()
    for r in ranks["2x2"]:
        got = r["init"][arch]
        assert set(got["params"]) == set(full)
        for k, v in full.items():
            v = v.numpy()
            block = v[got["slices"][k]] if k in got["slices"] else v
            np.testing.assert_array_equal(got["params"][k], block, err_msg=k)
        placed = {k for k, spec in got["specs"].items() if spec}
        assert placed == set(got["slices"])
        assert got["specs"] == got["jax_specs"]
        assert got["specs"]["embed.table"] == ("model",)
        assert got["specs"]["layers.0.attn.wq"] == ("data", "model")
        assert got["specs"]["layers.0.moe.wi"] == ("model", "data")
        assert got["specs"]["layers.0.ln1.scale"] == ()


def test_convert_gives_the_rank_its_blocks(runs):
    ranks, _ = runs
    for r in ranks["2x2"]:
        init = r["init"]["qwen3-moe-235b-a22b"]["params"]
        got = r["convert"]
        assert set(got) == set(init)
        for k, v in init.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_kill_device_at_across_ranks_matches_jax(runs):
    """``launch.train --kill-device-at 2`` on 4 ranks: (2, 2) → (1, 2) on
    ranks 0-1 (rank 2 idle, rank 3 lost), JAX's losses before and after;
    the survivors' parameters JAX's after the remesh; every rank returns
    the leader's losses."""
    ranks, want = runs
    w = want["kill"]
    assert w["mesh"] == {"data": 1, "model": 2}
    leader = ranks["2x2"][0]["kill"]
    assert len(w["losses"]) == len(leader["losses"]) == 5
    for a, b in zip(leader["losses"], w["losses"]):
        assert _rel(a, b) <= TOL, (leader["losses"], w["losses"])
    assert ("step     2 device lost → survivor mesh {'data': 1, 'model': 2}"
            " over 2/4 devices, live state migrated checkpoint-free"
            in leader["stdout"])
    # each step's gradients whole, from every rank's blocks: the kill
    # re-lays the leaves, so a survivor's element may have been another
    # rank's before it
    whole = []
    for step, want_g in enumerate(w["grads"]):
        g = {k: np.zeros(v.shape, v.dtype) for k, v in want_g.items()}
        for r in ranks["2x2"]:
            got = r["kill"]
            if step < len(got["grads"]):
                for k, block in got["grads"][step].items():
                    sl = got["grad_slices"][step].get(k)
                    g[k][(slice(None),) if sl is None else sl] = block
        whole.append(g)
    for r in ranks["2x2"]:
        got = r["kill"]
        assert got["losses"] == leader["losses"], r["rank"]
        assert got["grid"] == {"data": 1, "model": 2}
        assert got["idle"] == (r["rank"] >= 2)
        if got["idle"]:
            assert got["stdout"] == ""
            continue
        _params_close(got["params"], got["slices"], w["params"],
                      f"kill rank {r['rank']}", whole, w["grads"],
                      grad_slices=[{}] * len(whole))


@pytest.mark.parametrize("flag, item", [("checkpoint", "13d.8"),
                                        ("grad_wire", "13d.9")])
def test_launcher_refusals_across_ranks(runs, flag, item):
    ranks, _ = runs
    for r in ranks["2x2"]:
        got = r["refusals"][flag]
        assert got is not None and got[0] == "NotImplementedError"
        assert f"item {item}" in got[1], got


def test_remat_recomputes_under_the_forward_context(runs):
    """The backward taken in a thread without the activation context (the
    card's autograd runs it in a thread of its own) recomputes each remat
    layer under the forward's grid context: the same gradients as in the
    forward's thread."""
    ranks, _ = runs
    for r in ranks["2x2"]:
        assert r["thread"] == {"max_diff": 0.0}, r["thread"]


def test_serve_launcher_on_the_grid(runs):
    """``launch.serve`` under ``torchrun`` on the (2, 2) grid: every rank
    of data row d decodes row d's tokens, those of the one-process greedy
    generation of that row alone (the same capacity: a rank's tokens are
    its row's)."""
    from repro_torch.train.serve import generate

    ranks, _ = runs
    argv = W.SERVE_ARGV
    arg = {argv[i]: argv[i + 1] for i in range(len(argv) - 1)
           if argv[i].startswith("--")}
    b, s, n = int(arg["--batch"]), int(arg["--prompt-len"]), int(
        arg["--gen"])
    cfg = W.get_reduced(arg["--arch"])
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=torch
                            .Generator().manual_seed(1), dtype=torch.int32)
    for r in ranks["2x2"]:
        d = r["coords"]["data"]
        want = generate(model, prompts[d:d + 1], steps=n).numpy()
        np.testing.assert_array_equal(r["serve"], want, err_msg=str(r))


def test_rank_rows_of_microbatches():
    """``RankGrid.local_rows`` keeps shard d of each microbatch, as the
    JAX package reshapes (n, B/n, …) and then shards the batch dim; rows
    that the data axes do not divide stay whole."""
    class Grid:  # the attributes local_rows reads
        row_size, row_index, idle = 2, 1, False
        rows_split = shd.RankGrid.rows_split
        _member = shd.RankGrid._member

    x = np.arange(8)
    assert shd.RankGrid.local_rows(Grid(), x).tolist() == [4, 5, 6, 7]
    assert shd.RankGrid.local_rows(Grid(), x, microbatches=2).tolist() \
        == [2, 3, 6, 7]
    assert shd.RankGrid.local_rows(Grid(), x[:3]).tolist() == [0, 1, 2]
