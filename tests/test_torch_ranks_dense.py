"""The dense layers' FSDP × TP layout across ``torch.distributed`` ranks on
the CPU: ``models.Model`` on a ``dist.sharding.RankGrid`` of gloo ranks
against the JAX package's jitted model on an 8-device host mesh with Auto
axes under the same rules.

Three worlds, each spawned once for the module: (data, model) grids
(2, 2), (4, 2) and (1, 4) (tests/torch_model_ranks.py's ``DENSE_CASES``:
reduced stablelm-1.6b, qwen2-72b — GQA, biases, a cache by sequence, its 2
KV heads whole on the (1, 4) grid and cut to those a rank's q head reads —
zamba2-2.7b — the packed ``in_proj``, the hybrid's shared block —
mamba2-1.3b, whisper-base and qwen3-moe), in float32 from the port's
one-process init at the seed.  The JAX side runs meanwhile in three
subprocesses (tests/jax_mesh_oracle.py's ``dense`` mode), one a grid.

Held on each rank: every leaf's spec equal to JAX's ``tree_shardings``
spec (FSDP on data; TENSOR, HEADS, KV_HEADS, VOCAB and EXPERT on model;
the divisibility fallback); the init's blocks bit-equal to the one-process
init's and to ``convert.model_params_from_jax(mesh=grid)``; the forward's
logits (the rank's rows and vocabulary block), the loss, the prefill's
logits and every cache block within 1e-5 · max |want|; the greedy tokens
equal; two AdamW steps' losses and grad norms within 1e-5 (relative), each
leaf's gradient block and the parameters after the first step (see
``test_train_steps_match_jax`` for the bounds; the key bias, whose
gradient is zero in exact arithmetic and float32 noise in both packages,
against the layer's largest gradient).  On the (2, 2) world also:
stablelm's forward and loss under ``"fsdp"`` and ``"serve"`` (specs equal
JAX's under those rules), and a cache laid out by KV heads (16 KV heads:
every reduced arch's cache goes by sequence) held to the one-process port.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_model_ranks as W
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import Model
import test_torch_ranks_train as RT
from test_torch_ranks_moe import _collect, _oracle

TOL = 1e-5
WORLD_TIMEOUT_S = 400.0
CASES = [(g, a) for g, archs in W.DENSE_CASES.items() for a in archs]
IDS = [f"{g}-{a}" for g, a in CASES]
# a leaf whose gradient is zero in exact arithmetic: the key bias (q·b_k is
# the same for every key of a query, and softmax ignores it)
ZERO_GRADIENT = (".attn.bk",)
# leaves whose float32 gradient moves with the layout in JAX alone: the
# SSM's a_log, whose first gradient on JAX's mesh lies 1.46e-5 of its max
# from JAX's one-device gradient (the port's, 1.59e-5 from JAX's mesh);
# held within twice JAX's own distance
LAYOUT_NOISE = (".ssm.a_log",)
# the second step's gradient is taken where the two packages' parameters
# differ at the first step's noise elements (by up to 8.1e-5 on these
# runs: zamba2's in_proj), which moves every gradient of the layers they
# feed (at most 4.4e-5 of a leaf's max on these runs, zamba2's
# norm_scale); held as tests/test_torch_train_step.py holds the
# one-process port's gradients against JAX's
SECOND_GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense_ranks")
    oracles = {g: _oracle("dense", tmp / f"{g}.pkl", g)
               for g in W.DENSE_GRIDS}
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            futures = {g: ex.submit(
                spawn_ranks, W.dense_world, dp * mp,
                (mp, list(W.DENSE_CASES[g]), g == W.DENSE_STRATEGY_CASE[0]),
                backend="gloo", init_method=f"file://{tmp}/{g}",
                timeout_s=WORLD_TIMEOUT_S)
                for g, (dp, mp) in W.DENSE_GRIDS.items()}
            heads = W.heads_one_process()
            ranks = {g: f.result() for g, f in futures.items()}
        want = {}
        for g, proc in oracles.items():
            want.update(_collect(proc, tmp / f"{g}.pkl", WORLD_TIMEOUT_S))
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ranks, want, heads


def _grid(g, rank, strategy="2d"):
    """The rank's layout without a process group."""
    return shd.TracedGrid(dict(zip(("data", "model"), W.DENSE_GRIDS[g])),
                          rank=rank, strategy=strategy, device="cpu")


def _close(got, want, what, tol=TOL, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} · {scale}"


def _logits_block(grid, logits, full):
    """The rank's rows and vocabulary block of ``full`` (B, S, V)."""
    rows = full[grid.local_rows(np.arange(full.shape[0]))]
    v = logits.shape[-1]
    if v == full.shape[-1]:
        return rows
    return rows[..., grid.model_index * v:(grid.model_index + 1) * v]


def _cache_block(grid, cfg, name, full, b):
    """The rank's block of a whole cache leaf (layers, B, …): its rows,
    then its spec with the batch dim left out."""
    _, axes = Model(cfg, device="meta").init_cache(b, W.DENSE_S
                                                   + W.DENSE_GEN)
    rows = grid.local_rows(np.arange(b))
    full = full[:, rows]
    ax = tuple(None if a == shd.BATCH else a for a in axes[name])
    spec = grid.param_spec(full.shape, ax)
    return full[grid.local_slice(full.shape, spec)] if spec else full


@pytest.mark.parametrize("grid, arch", CASES, ids=IDS)
def test_specs_equal_jax(runs, grid, arch):
    ranks, want, _ = runs
    w = want[grid, arch]["specs"]["2d"]
    for r in ranks[grid]:
        got = r["cases"][arch]["specs"]
        assert got == w, (grid, arch, r["rank"],
                          {k: (got.get(k), w.get(k)) for k in w
                           if got.get(k) != w.get(k)})
        # a rank holds its block of each placed leaf and no more
        sliced = r["cases"][arch]["slices"]
        assert set(sliced) == {k for k, s in got.items() if s}


@pytest.mark.parametrize("grid, arch", CASES, ids=IDS)
def test_init_blocks_equal_the_one_process_init(runs, grid, arch):
    ranks, _, _ = runs
    cfg = W.dense_cfg(arch)
    full = Model(cfg, device="cpu").init(torch.Generator().manual_seed(
        W.SEED)).state_dict()
    for r in ranks[grid]:
        got = r["cases"][arch]
        assert set(got["init"]) == set(full) == set(got["convert"])
        for k, v in full.items():
            sl = got["slices"].get(k)
            block = v.numpy() if sl is None else v.numpy()[sl]
            np.testing.assert_array_equal(got["init"][k], block, err_msg=k)
            np.testing.assert_array_equal(got["convert"][k], block,
                                          err_msg=k)


@pytest.mark.parametrize("grid, arch", CASES, ids=IDS)
def test_serving_matches_jax(runs, grid, arch):
    """The forward's logits and the loss, the prefill's last logits and
    cache blocks, the greedy tokens of the rank's rows."""
    ranks, want, _ = runs
    w = want[grid, arch]["serve"]
    cfg = W.dense_cfg(arch)
    for r in ranks[grid]:
        g = _grid(grid, r["rank"])
        got = r["cases"][arch]["serve"]
        where = f"{grid} {arch} rank {r['rank']}"
        _close(got["logits"], _logits_block(g, got["logits"], w["logits"]),
               f"{where} logits", scale=float(np.abs(w["logits"]).max()))
        # each data row's cross-entropy is its part of the global batch's
        # mean; the MoE term is the global batch's on every rank
        parts = [rr["cases"][arch]["serve"]["ce"] for rr in ranks[grid]
                 if rr["coords"]["model"] == 0]
        loss = sum(parts) + got["aux"]
        assert abs(loss - w["loss"]) <= TOL * abs(w["loss"]), where
        _close(got["prefill"], _logits_block(g, got["prefill"],
                                             w["prefill"]),
               f"{where} prefill", scale=float(np.abs(w["prefill"]).max()))
        assert set(got["cache"]) - {"cache_len"} == set(w["cache"]), where
        for name, full in w["cache"].items():
            _close(got["cache"][name],
                   _cache_block(g, cfg, name, full, W.DENSE_B),
                   f"{where} cache {name}",
                   scale=max(float(np.abs(full).max()), 1e-30))
        rows = g.local_rows(np.arange(W.DENSE_B))
        np.testing.assert_array_equal(got["tokens"], w["tokens"][rows],
                                      err_msg=where)


@pytest.mark.parametrize("grid, arch", CASES, ids=IDS)
def test_train_steps_match_jax(runs, grid, arch):
    """Two AdamW steps: the losses and grad norms within 1e-5; the first
    step's gradient block of every leaf (the gradient the update was given:
    its parts summed over the batch axes) within 1e-5 · max |want|, the
    leaves of LAYOUT_NOISE within twice JAX's own distance between its
    mesh's and one device's gradient; the parameters after the first step
    (where the second gradient is taken) within 1e-5 · max |want| outside
    the first step's noise elements, which are held within NOISE_MOVE
    (:func:`_params_after_close`); the second step's gradient blocks within
    SECOND_GRAD_TOL · max |want|."""
    ranks, want, _ = runs
    w = want[grid, arch]["train"]
    first = ranks[grid][0]["cases"][arch]["train"]
    for r in ranks[grid]:
        got = r["cases"][arch]["train"]
        slices = r["cases"][arch]["slices"]
        where = f"{grid} {arch} rank {r['rank']}"
        assert got["losses"] == first["losses"], where
        for a, b in zip(got["losses"] + got["grad_norms"],
                        w["losses"] + w["grad_norms"]):
            assert abs(a - b) <= TOL * abs(b), (where, got, w["losses"],
                                                w["grad_norms"])
        for step, (gg, jg) in enumerate(zip(got["grads"], w["grads"])):
            assert set(gg) == set(jg), where
            for k, full in jg.items():
                scale = float(np.abs(full).max())
                if k.endswith(ZERO_GRADIENT):
                    layer = k.rsplit(".", 2)[0]
                    scale = max(float(np.abs(v).max()) for n, v in jg.items()
                                if n.startswith(layer + "."))
                tol = TOL if step == 0 else SECOND_GRAD_TOL
                if step == 0 and k.endswith(LAYOUT_NOISE):
                    own = float(np.abs(full - w["grads_one_device"][k])
                                .max())
                    tol = max(tol, 2 * own / scale)
                _close(gg[k], _cut(full, slices.get(k)),
                       f"{where} step {step} d{k}", tol=tol, scale=scale)
        _params_after_close(got["params"][0], w["params"][0], slices,
                            got["grads"][0], w["grads"][0], where)


def _cut(a, sl):
    return a if sl is None else a[sl]


def _params_after_close(got, want, slices, grads, jax_grads, where):
    """Each leaf's block after the first step within 1e-5 · max |want|,
    except at the elements whose first gradient was float32 noise (0 < |g|
    ≤ NOISE of the whole leaf's max in JAX's gradient) in the rank's
    gradient or in JAX's (an element at the threshold may fall on either
    side of it in the two packages: whisper's decoder.0.attn.wq has one at
    1.013e-5 of the max in JAX's and 0.990e-5 in the port's), and in
    the ZERO_GRADIENT leaves: Adam's first step moves such an element by
    lr·g/(|g| + eps), which turns a last-bit gradient difference into a
    move of up to lr; those are held within NOISE_MOVE."""
    assert set(got) == set(want), where
    for k, full in want.items():
        sl = slices.get(k)
        block = _cut(full, sl)
        diff = np.abs(got[k] - block)
        noisy = np.full(diff.shape, k.endswith(ZERO_GRADIENT))
        top = RT.NOISE * float(np.abs(jax_grads[k]).max())
        for g in (grads[k], _cut(jax_grads[k], sl)):
            noisy |= (g != 0) & (np.abs(g) <= top)
        err = float(diff[~noisy].max()) if (~noisy).any() else 0.0
        scale = float(np.abs(block).max())
        assert err <= TOL * scale, f"{where} {k}: {err} > {TOL} · {scale}"
        if noisy.any():
            moved = float(diff[noisy].max())
            assert moved <= RT.NOISE_MOVE, (where, k, moved, RT.NOISE_MOVE)


@pytest.mark.parametrize("strategy", ["fsdp", "serve"])
def test_other_rule_tables(runs, strategy):
    """stablelm's forward and loss under ``"fsdp"`` (batch and FSDP over
    every axis) and ``"serve"`` (the weights replicated over data): the
    specs JAX's under those rules, the logits and the loss JAX's."""
    ranks, want, _ = runs
    grid, arch = W.DENSE_STRATEGY_CASE
    w = want[grid, arch]
    losses = []
    for r in ranks[grid]:
        got = r["strategies"][strategy]
        assert got["specs"] == w["specs"][strategy], (strategy, r["rank"])
        mi, v = got["vocab"]
        full = w["serve"]["logits"][got["rows"]]
        if v != full.shape[-1]:
            full = full[..., mi * v:(mi + 1) * v]
        _close(got["logits"], full, f"{strategy} rank {r['rank']} logits",
               scale=float(np.abs(w["serve"]["logits"]).max()))
        losses.append((tuple(got["rows"]), got["ce"]))
    # each distinct row block's share of the mean, once
    total = sum(dict(losses).values())
    assert abs(total - w["serve"]["loss"]) <= TOL * abs(w["serve"]["loss"])


def test_cache_by_kv_heads_matches_one_process(runs):
    """A cache laid out by KV heads (Hkv divides 16) on the (2, 2) grid:
    the rank's rows, logits, prefill, cache blocks (its KV heads) and
    greedy tokens against the one-process port."""
    ranks, _, heads = runs
    grid = W.DENSE_STRATEGY_CASE[0]
    cfg = W.dense_cfg(W.DENSE_STRATEGY_CASE[1], **W.HEADS_CFG)
    for r in ranks[grid]:
        g = _grid(grid, r["rank"])
        got = r["heads"]
        where = f"heads rank {r['rank']}"
        _close(got["logits"], _logits_block(g, got["logits"],
                                            heads["logits"]),
               f"{where} logits", scale=float(np.abs(heads["logits"]).max()))
        _close(got["prefill"], _logits_block(g, got["prefill"],
                                             heads["prefill"]),
               f"{where} prefill",
               scale=float(np.abs(heads["prefill"]).max()))
        for name in ("k", "v"):
            block = _cache_block(g, cfg, name, heads["cache"][name],
                                 W.DENSE_B)
            assert block.shape[-2] == cfg.num_kv_heads // g.mp
            _close(got["cache"][name], block, f"{where} cache {name}",
                   scale=float(np.abs(heads["cache"][name]).max()))
        rows = g.local_rows(np.arange(W.DENSE_B))
        np.testing.assert_array_equal(got["tokens"], heads["tokens"][rows])


def test_no_rank_imported_jax(runs):
    ranks, _, _ = runs
    for g, rs in ranks.items():
        for r in rs:
            assert r["imports"] == [], (g, r["rank"], r["imports"])
            assert r["coords"] == {"data": r["rank"] // W.DENSE_GRIDS[g][1],
                                   "model": r["rank"] % W.DENSE_GRIDS[g][1]}
