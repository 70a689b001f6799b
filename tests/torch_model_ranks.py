"""The model path across ranks: case tables and rank entries for
tests/test_torch_ranks_moe.py and tests/test_torch_ranks_train.py, and the
case tables tests/jax_mesh_oracle.py runs the JAX package's side of.

``launch.mesh.spawn_ranks`` runs the ``*_world`` entries in spawned gloo
processes on the CPU.  This module imports ``repro_torch`` (and numpy,
torch), nothing of the JAX package.  Parameters are the port's
one-process init from ``SEED`` (a rank on a ``RankGrid`` draws the same
and keeps its block); inputs are NumPy draws from a seed.
"""
import sys

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import RankGrid
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.train.step import sum_partial_grads

SEED = 0
MOE_ARCHS = {"qwen3": "qwen3-moe-235b-a22b", "llama4": "llama4-scout-17b-a16e"}
# float32, and a capacity that drops assignments per shard
MOE_OVER = {"dtype": "float32", "capacity_factor": 0.5}

# name → (arch key, (dp, mp), B, S, config overrides beyond MOE_OVER)
MOE_CASES = {
    "qwen3/2x2/rows": ("qwen3", (2, 2), 4, 8, {}),
    "llama4/2x2/rows": ("llama4", (2, 2), 4, 8, {}),
    # the rows held whole, dp | t: each data rank takes a block of tokens
    "qwen3/2x2/blocks": ("qwen3", (2, 2), 1, 16, {}),
    # t % dp != 0: every token on every rank, capacity_for(t)
    "qwen3/2x2/t_odd": ("qwen3", (2, 2), 1, 7, {}),
    # e % mp != 0: the experts replicate, the local path over every token
    "qwen3/2x2/e3_rows": ("qwen3", (2, 2), 4, 8, {"num_experts": 3}),
    "qwen3/2x2/e3_whole": ("qwen3", (2, 2), 1, 7, {"num_experts": 3}),
    "qwen3/4x2/rows": ("qwen3", (4, 2), 8, 8, {}),
    "llama4/4x2/rows": ("llama4", (4, 2), 8, 8, {}),
    "qwen3/1x4/whole": ("qwen3", (1, 4), 2, 8, {}),
    "llama4/1x4/whole": ("llama4", (1, 4), 2, 8, {}),
}
MOE_GRIDS = {"2x2": (2, 2), "4x2": (4, 2), "1x4": (1, 4)}

# train: arch → config overrides; each runs 3 steps of B × S, microbatches 2
TRAIN_ARCHS = {"qwen3-moe-235b-a22b": {}, "llama4-scout-17b-a16e": {},
               "stablelm-1.6b": {}}
TRAIN_GRIDS = {"2x2": (2, 2), "4x2": (4, 2)}
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MB = 8, 16, 3, 2
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
DATA_SEED = 1
# launch.serve on a (2, 2) grid: a row of B=2 on each data row
SERVE_ARGV = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--batch", "2",
              "--prompt-len", "16", "--gen", "6", "--device", "cpu"]
# launch.train --kill-device-at on a (2, 2) grid of 4 ranks
KILL_ARGV = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--steps", "5",
             "--batch", "8", "--seq", "16", "--kill-device-at", "2",
             "--log-every", "1", "--device", "cpu", "--dtype", "float32",
             "--microbatches", "2"]


def moe_cfg(case):
    arch, _, _, _, over = MOE_CASES[case]
    return get_reduced(MOE_ARCHS[arch]).replace(**MOE_OVER, **over)


def moe_node(cfg, mesh=None, device="cpu"):
    """The MoE's parameter tree (a shared expert as a child), from SEED."""
    children = {}
    if cfg.shared_expert:
        children["shared"] = L.ParamNode(
            L.ffn_leaves(cfg.d_model, cfg.d_ff, cfg.activation),
            device=device, mesh=mesh)
    node = L.ParamNode(M.moe_leaves(cfg), children, device=device,
                       mesh=mesh)
    node.init_(torch.Generator().manual_seed(SEED))
    return node


def moe_inputs(case, cfg):
    """x (B, S, D) and the output's cotangent, float32."""
    _, _, b, s, _ = MOE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x, cot


def moe_grads_f64(case, sharded: bool) -> dict:
    """The case's gradients (x and every parameter, whole) in float64 on
    one process, laid out as the JAX package lays out the case: with
    ``sharded``, each of the dp data shards of the tokens dispatched with
    its own capacity; the aux loss the global batch's.  The router's
    logits stay float32 (``_route`` casts them), as on both sides."""
    cfg = moe_cfg(case)
    _, (dp, _), b, s, _ = MOE_CASES[case]
    state = {k: v.detach().double().requires_grad_(True)
             for k, v in moe_node(cfg).state_dict().items()}
    p = {k: v for k, v in state.items() if "." not in k}
    if cfg.shared_expert:
        p["shared"] = {k.split(".")[1]: v for k, v in state.items()
                       if k.startswith("shared.")}
    x0, cot0 = moe_inputs(case, cfg)
    x = torch.from_numpy(x0).double().requires_grad_(True)
    xf = x.reshape(b * s, -1)
    gates, ids, aux = M._route(p, xf, cfg)
    blocks = dp if sharded else 1
    per = b * s // blocks
    out = torch.cat([M._moe_local(
        p, xf[i * per:(i + 1) * per], gates[i * per:(i + 1) * per],
        ids[i * per:(i + 1) * per], cfg, M.capacity_for(per, cfg), None)
        for i in range(blocks)]).reshape(x.shape)
    if cfg.shared_expert:
        out = out + L.ffn(p["shared"], x, cfg.activation)
    loss = (out * torch.from_numpy(cot0).double()).sum() + aux
    grads = torch.autograd.grad(loss, (x, *state.values()))
    return {k: g.numpy() for k, g in zip(("x", *state), grads)}


def full_state(node) -> dict:
    return {k: v.detach().numpy().copy() for k, v in node.state_dict().items()}


def _moe_case(grid, case) -> dict:
    cfg = moe_cfg(case)
    _, _, b, _, _ = MOE_CASES[case]
    node = moe_node(cfg, grid)
    x_full, cot_full = moe_inputs(case, cfg)
    x = grid.local_rows(torch.from_numpy(x_full)).clone().requires_grad_(True)
    cot = grid.local_rows(torch.from_numpy(cot_full))
    names, params = zip(*node.named_parameters())
    stats: dict = {}
    for p in params:
        p.requires_grad_(True)
    with shd.activation_sharding(grid, shd.make_rules(grid), batch=b):
        out, aux = M.moe_ffn(node, x, cfg, return_aux=True, stats=stats)
        loss = (out * cot).sum() + aux
        grads = torch.autograd.grad(loss, (x, *params))
    grads = dict(zip(("x", *names), (g.detach() for g in grads)))
    specs = _specs(node)
    if grid.rows_split(b):  # the parameters' gradients' parts summed
        x_grad = grads.pop("x")
        grads = {"x": x_grad, **sum_partial_grads(grid, grads, specs)}
    rows = np.arange(b)
    return {
        "out": out.detach().numpy(), "aux": float(aux),
        "stats": (int(stats["assignments"]), int(stats["dropped"])),
        "grads": {k: v.numpy() for k, v in grads.items()},
        "rows": grid.local_rows(rows),
        "slices": _sliced(node),
        "specs": specs,
        "jax_specs": {k: shd.spec_for(shape, axes, grid, shd.make_rules(grid))
                      for k, (shape, axes) in _leaf_axes(node).items()},
        "local_shapes": {k: tuple(v.shape) for k, v in
                         node.state_dict().items()},
    }


def _specs(node) -> dict:
    out = {}
    for prefix, mod in node.named_modules():
        if isinstance(mod, L.ParamNode):
            for k in mod._leaves:
                out[f"{prefix}.{k}" if prefix else k] = mod.spec(k)
    return out


def _sliced(node) -> dict:
    out = {}
    for prefix, mod in node.named_modules():
        if isinstance(mod, L.ParamNode):
            for k, sl in mod.sliced().items():
                out[f"{prefix}.{k}" if prefix else k] = sl
    return out


def moe_world(rank, world, mp, cases) -> dict:
    """One rank of a MoE world: each case on a (world/mp, mp) grid."""
    torch.set_num_threads(1)
    grid = RankGrid(mp, device="cpu")
    out = {"rank": rank, "coords": dict(grid.coords), "cases": {}}
    for case in cases:
        out["cases"][case] = _moe_case(grid, case)
    out["imports"] = sorted(name for name in sys.modules
                            if name.split(".")[0] in ("jax", "jaxlib",
                                                      "repro"))
    return out


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def train_cfg(arch):
    return get_reduced(arch).replace(dtype="float32", **TRAIN_ARCHS[arch])


def _train_case(grid, arch) -> dict:
    from repro_torch.models import Model
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.step import make_train_step

    cfg = train_cfg(arch)
    model = Model(cfg, device="cpu", mesh=grid).init(
        torch.Generator().manual_seed(SEED))
    seen: list = []

    class Recording(AdamW):
        def update(self, model, grads, state):
            seen.append({k: g.detach().clone() for k, g in grads.items()})
            return super().update(model, grads, state)

    opt = Recording(AdamWConfig(**TRAIN_OPT))
    state = opt.init(model)
    step = make_train_step(model, opt, microbatches=TRAIN_MB)
    data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=DATA_SEED)
    losses, gnorms = [], []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, data.next_batch())
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "grad_norms": gnorms,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "grads": [{k: g.numpy() for k, g in step_grads.items()}
                      for step_grads in seen],
            "slices": _sliced(model), "num_params": model.num_params()}


def init_slices(grid, arch) -> dict:
    """Model(cfg, mesh=grid).init(SEED)'s leaves and their blocks."""
    from repro_torch.models import Model

    cfg = get_reduced(arch)
    model = Model(cfg, device="cpu", mesh=grid).init(
        torch.Generator().manual_seed(SEED))
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "slices": _sliced(model),
            "specs": {k: grid.param_spec(shape, axes) for k, (shape, axes)
                      in _leaf_axes(model).items()},
            "jax_specs": {k: shd.spec_for(shape, axes, grid,
                                          shd.make_rules(grid))
                          for k, (shape, axes) in _leaf_axes(model).items()}}


def _leaf_axes(model) -> dict:
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, L.ParamNode):
            for k, leaf in mod._leaves.items():
                out[f"{prefix}.{k}" if prefix else k] = (leaf.shape,
                                                         leaf.axes)
    return out


def convert_slices(grid, arch) -> dict:
    """``convert.model_params_from_jax(..., mesh=grid)`` of a one-process
    state turned into the JAX tree: the rank's blocks."""
    from repro_torch.convert import model_params_from_jax
    from repro_torch.models import Model

    cfg = get_reduced(arch)
    full = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    tree = jax_style_tree(full)
    got = model_params_from_jax(tree, full.axes(), cfg, mesh=grid)
    return {k: v.numpy() for k, v in got.items()}


def jax_style_tree(model) -> dict:
    """A port model's parameters as the JAX package's tree (NumPy leaves,
    the layers stacked on a leading axis)."""
    flat = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    depth = {"layers": model.cfg.num_layers, "decoder": model.cfg.num_layers,
             "encoder": model.cfg.num_encoder_layers}

    def walk(ax, path):
        if isinstance(ax, dict):
            return {k: walk(v, path + (k,)) for k, v in ax.items()}
        if ax and ax[0] == "layers":
            return np.stack([flat[".".join((path[0], str(i)) + path[1:])]
                             for i in range(depth[path[0]])])
        return flat[".".join(path)]

    return walk(model.axes(), ())


def train_world(rank, world, mp, archs, extras) -> dict:
    """One rank of a training world: each arch's steps on a (world/mp, mp)
    grid; with ``extras``, the init and convert blocks and the launcher
    (its kill, its refusals)."""
    torch.set_num_threads(1)
    grid = RankGrid(mp, device="cpu")
    out = {"rank": rank, "coords": dict(grid.coords), "train": {}}
    for arch in archs:
        out["train"][arch] = _train_case(grid, arch)
    if extras:
        out["thread"] = backward_in_a_thread(grid)
        out["init"] = {a: init_slices(grid, a) for a in
                       ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")}
        out["convert"] = convert_slices(grid, "qwen3-moe-235b-a22b")
        out["kill"] = _launcher(world)
        out["refusals"] = _launcher_refusals(world)
        out["serve"] = _serve(world)
    return out


def _serve(world):
    """``launch.serve`` under ``torchrun``'s environment: the rank's rows'
    tokens."""
    import contextlib
    import io
    import os

    from repro_torch.launch import serve

    os.environ["WORLD_SIZE"] = str(world)
    with contextlib.redirect_stdout(io.StringIO()):
        return serve.main(SERVE_ARGV).numpy()


def backward_in_a_thread(grid) -> dict:
    """reduced qwen3-moe's loss (remat on) under the grid's context, its
    gradients taken once in this thread and once in another one that has
    no context — as the card's autograd engine runs the backward in a
    thread of its own → the largest difference between the two (0: the
    recomputed layers ran under the forward's context)."""
    import threading

    from repro_torch.models import Model
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import _requiring_grad, as_batch

    cfg = train_cfg("qwen3-moe-235b-a22b")
    assert cfg.remat
    model = Model(cfg, device="cpu", mesh=grid).init(
        torch.Generator().manual_seed(SEED))
    batch = as_batch({k: grid.local_rows(v) for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=DATA_SEED).next_batch()
        .items()}, "cpu")
    params = list(model.parameters())
    grads, errors = [], []
    with _requiring_grad(params):
        for where in ("here", "thread"):
            with shd.activation_sharding(grid, shd.make_rules(grid),
                                         batch=TRAIN_B):
                loss = model.train_loss(batch)

            def back(loss=loss):
                try:
                    grads.append(torch.autograd.grad(loss, params))
                except Exception as e:  # reported to the parent
                    errors.append(repr(e))

            if where == "here":
                back()
            else:
                t = threading.Thread(target=back)
                t.start()
                t.join()
    if errors:
        return {"error": errors[0]}
    return {"max_diff": max(float((a - b).abs().max())
                            for a, b in zip(*grads))}


def _launcher(world) -> dict:
    import contextlib
    import io
    import os

    from repro_torch.launch import train as tlaunch

    from repro_torch.train.optimizer import AdamW

    os.environ["WORLD_SIZE"] = str(world)
    buf = io.StringIO()
    seen: list = []
    seen_slices: list = []
    update = AdamW.update

    def recording(self, model, grads, state):  # the launcher's gradients
        seen.append({k: g.detach().numpy().copy() for k, g in grads.items()})
        seen_slices.append(_sliced(model))  # the blocks of that step's grid
        return update(self, model, grads, state)

    AdamW.update = recording
    try:
        with contextlib.redirect_stdout(buf):
            run = tlaunch.train(tlaunch.parse_args(KILL_ARGV))
    finally:
        AdamW.update = update
    model, grid = run["model"], run["grid"]
    return {"losses": run["losses"], "stdout": buf.getvalue(),
            "idle": grid.idle, "grid": dict(grid.shape),
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "grads": seen, "grad_slices": seen_slices,
            "slices": _sliced(model)}


def _launcher_refusals(world) -> dict:
    import os

    from repro_torch.launch import train as tlaunch

    os.environ["WORLD_SIZE"] = str(world)
    out = {}
    for flag, extra in (("checkpoint", ["--checkpoint-dir", "/nonexistent"]),
                        ("grad_wire", ["--grad-wire", "int8"])):
        try:
            tlaunch.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                          "1", "--device", "cpu", *extra])
            out[flag] = None
        except Exception as e:  # reported to the parent, which asserts
            out[flag] = (type(e).__name__, str(e))
    return out


# --------------------------------------------------------------------------
# the dense layers' layout (tests/test_torch_ranks_dense.py)
# --------------------------------------------------------------------------
DENSE_GRIDS = {"2x2": (2, 2), "4x2": (4, 2), "1x4": (1, 4)}
DENSE_ALL = ("stablelm-1.6b", "qwen2-72b", "zamba2-2.7b", "mamba2-1.3b",
             "whisper-base", "qwen3-moe-235b-a22b")
#: grid → the archs it runs
DENSE_CASES = {"2x2": ("stablelm-1.6b", "zamba2-2.7b", "whisper-base"),
               "4x2": ("qwen2-72b", "mamba2-1.3b", "qwen3-moe-235b-a22b"),
               "1x4": ("qwen2-72b", "zamba2-2.7b", "qwen3-moe-235b-a22b")}
#: the forward and loss under the other rule tables: (grid, arch)
DENSE_STRATEGY_CASE = ("2x2", "stablelm-1.6b")
DENSE_B, DENSE_S, DENSE_GEN = 4, 8, 4
DENSE_TRAIN_B, DENSE_TRAIN_STEPS = 8, 2
# the KV cache by KV heads (Hkv divides 16): reduced stablelm with 16
# heads of 16, held against the one-process port
HEADS_CFG = dict(num_heads=16, num_kv_heads=16, head_dim=16)


def dense_cfg(arch, **over):
    return get_reduced(arch).replace(dtype="float32", **over)


def dense_inputs(cfg, b, seed):
    """tokens, labels (and frames) of ``b`` rows of DENSE_S, NumPy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, DENSE_S),
                                  dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, DENSE_S),
                                  dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = 0.02 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _tree_np(t):
    return {k: v if isinstance(v, int) else v.detach().numpy().copy()
            for k, v in t.items()}


def _dense_serve(model, grid, cfg, inputs, b):
    """forward logits, the loss, the prefill's logits and cache, and the
    greedy tokens of the rank's rows."""
    from repro_torch.train.serve import generate

    batch = {k: torch.from_numpy(grid.local_rows(v))
             for k, v in inputs.items()}
    serve = {k: v for k, v in batch.items() if k != "labels"}
    extra = {k: v for k, v in serve.items() if k != "tokens"}
    parts: dict = {}
    with torch.no_grad(), shd.activation_sharding(grid, grid.rules,
                                                  batch=b):
        logits, _ = model.forward(batch)
        model.train_loss(batch, parts=parts)
        pl, cache = model.prefill(serve, cache_len=DENSE_S + DENSE_GEN)
        toks = generate(model, batch["tokens"], steps=DENSE_GEN,
                        batch_extra=extra)
    return {"logits": logits.numpy(), "ce": float(parts["ce"]),
            "aux": float(parts["aux"]),
            "prefill": pl.numpy(), "cache": _tree_np(cache),
            "tokens": toks.numpy()}


def _dense_train(model, cfg, inputs) -> dict:
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.step import make_train_step

    seen: list = []

    class Recording(AdamW):
        def update(self, model, grads, state):
            seen.append({k: g.detach().numpy().copy()
                         for k, g in grads.items()})
            return super().update(model, grads, state)

    opt = Recording(AdamWConfig(**TRAIN_OPT))
    state = opt.init(model)
    step = make_train_step(model, opt)
    losses, gnorms, params = [], [], []
    for batch in inputs:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        params.append({k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()})
    return {"losses": losses, "grad_norms": gnorms, "grads": seen,
            "params": params}


def train_batches(cfg):
    return [dense_inputs(cfg, DENSE_TRAIN_B, 100 + i)
            for i in range(DENSE_TRAIN_STEPS)]


def _dense_case(grid, arch) -> dict:
    from repro_torch.convert import model_params_from_jax
    from repro_torch.models import Model

    cfg = dense_cfg(arch)
    model = Model(cfg, device="cpu", mesh=grid).init(
        torch.Generator().manual_seed(SEED))
    out = {"specs": model.leaf_specs(), "slices": _sliced(model),
           "init": {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}}
    full = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    out["convert"] = {k: v.numpy() for k, v in model_params_from_jax(
        jax_style_tree(full), full.axes(), cfg, mesh=grid).items()}
    out["serve"] = _dense_serve(model, grid, cfg,
                                dense_inputs(cfg, DENSE_B, 7), DENSE_B)
    out["train"] = _dense_train(model, cfg, train_batches(cfg))
    return out


def dense_world(rank, world, mp, archs, extras) -> dict:
    """One rank of a dense-layout world: each arch on a (world/mp, mp)
    grid (specs, init and convert blocks, serving, two AdamW steps); with
    ``extras``, the other rule tables' forward and loss and the cache laid
    out by KV heads."""
    torch.set_num_threads(1)
    grid = RankGrid(mp, device="cpu")
    out = {"rank": rank, "coords": dict(grid.coords), "cases": {}}
    for arch in archs:
        out["cases"][arch] = _dense_case(grid, arch)
    if extras:
        from repro_torch.models import Model

        arch = DENSE_STRATEGY_CASE[1]
        cfg = dense_cfg(arch)
        inputs = dense_inputs(cfg, DENSE_B, 7)
        out["strategies"] = {}
        for strategy in ("fsdp", "serve"):
            g = RankGrid(mp, device="cpu", strategy=strategy,
                         _groups=grid._groups)
            model = Model(cfg, device="cpu", mesh=g).init(
                torch.Generator().manual_seed(SEED))
            batch = {k: torch.from_numpy(g.local_rows(v))
                     for k, v in inputs.items()}
            parts: dict = {}
            with torch.no_grad(), shd.activation_sharding(g, g.rules,
                                                          batch=DENSE_B):
                logits, _ = model.forward(batch)
                model.train_loss(batch, parts=parts)
            out["strategies"][strategy] = {
                "specs": model.leaf_specs(), "logits": logits.numpy(),
                "ce": float(parts["ce"]),
                "rows": g.local_rows(np.arange(DENSE_B)),
                "vocab": (g.model_index, logits.shape[-1])}
        cfg = dense_cfg(arch, **HEADS_CFG)
        model = Model(cfg, kernel="reference", device="cpu", mesh=grid).init(
            torch.Generator().manual_seed(SEED))
        out["heads"] = _dense_serve(model, grid, cfg, inputs, DENSE_B)
    out["imports"] = sorted(name for name in sys.modules
                            if name.split(".")[0] in ("jax", "jaxlib",
                                                      "repro"))
    return out


def heads_one_process() -> dict:
    """The KV-heads cache case on one process (the port's own run)."""
    from repro_torch.models import Model

    cfg = dense_cfg(DENSE_STRATEGY_CASE[1], **HEADS_CFG)
    model = Model(cfg, kernel="reference", device="cpu").init(
        torch.Generator().manual_seed(SEED))
    inputs = dense_inputs(cfg, DENSE_B, 7)
    from repro_torch.train.serve import generate

    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    serve = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, _ = model.forward(batch)
        pl, cache = model.prefill(serve, cache_len=DENSE_S + DENSE_GEN)
        toks = generate(model, batch["tokens"], steps=DENSE_GEN)
    return {"logits": logits.numpy(), "prefill": pl.numpy(),
            "cache": _tree_np(cache), "tokens": toks.numpy()}


# --------------------------------------------------------------------------
# the dry run's account of a grid (tests/test_torch_dryrun_grid.py)
# --------------------------------------------------------------------------
def trace_summary(trace) -> dict:
    """An op counter's trace as its dots (op, result elements,
    contraction, weight) and its collectives (kind, result bytes, group,
    axis), in order."""
    return {"dots": [tuple(ev[1:4]) + (ev[-1],) for ev in trace
                     if ev[0] == "dot"],
            "collectives": [(ev[1], ev[2], ev[3], ev[6]) for ev in trace
                            if ev[0] == "collective"]}


def grid_trace_world(rank, world, mp, cells, b, s) -> dict:
    """One rank of a gloo world: each (arch, shape) cell's step built by
    ``dryrun.build_step`` on the rank's ``RankGrid`` (the reduced config,
    the reference kernels, on the CPU) and run once under a CPU op
    counter → its trace summary."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpCounter

    torch.set_num_threads(1)
    grid = RankGrid(mp, device="cpu")
    out = {}
    for arch, shape in cells:
        step = dryrun.build_step(arch, shape, reduced=True, batch=b, seq=s,
                                 kernel="reference", device="cpu",
                                 grid=grid)
        with OpCounter(device="cpu") as counter:
            step.run()
        out[arch, shape] = trace_summary(counter.trace)
    return {"rank": rank, "cells": out}
