"""The JAX package's side of tests/test_torch_ranks_moe.py and
tests/test_torch_ranks_train.py, run as a subprocess:

    python tests/jax_mesh_oracle.py {moe|train|kill|dense|hlo} OUT.pkl [ARG ...]

It asks XLA for 8 host CPU devices before importing ``jax`` and lays them
out with ``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``: the
default Explicit axes refuse the package's ``with_sharding_constraint``
under jax 0.9.  The cases are tests/torch_model_ranks.py's; parameters are
the port's one-process init from its seed, carried across as NumPy
arrays, and the inputs the same NumPy draws.  The result, a pickle of
NumPy arrays keyed by case, is written to OUT.pkl; the train and kill
modes include the gradients each step's AdamW update was given.
"""
import os
import pickle
import sys


def _setup():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "..", "src"))


def _mesh(shape):
    import jax
    from jax.sharding import AxisType

    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix="") -> dict:
    import numpy as np

    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def moe_oracle() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import torch_model_ranks as W
    from repro.configs import get_reduced
    from repro.dist import sharding as shd
    from repro.models import moe

    out = {}
    for case, (arch, shape, b, s, over) in W.MOE_CASES.items():
        tcfg = W.moe_cfg(case)
        cfg = get_reduced(W.MOE_ARCHS[arch]).replace(**W.MOE_OVER, **over)
        p = jax.tree.map(jnp.asarray, _nest(W.full_state(W.moe_node(tcfg))))
        x, cot = (jnp.asarray(a) for a in W.moe_inputs(case, tcfg))

        def f(p, x):
            y, aux = moe.moe_ffn(p, x, cfg, return_aux=True)
            return jnp.sum(y * cot) + aux, (y, aux)

        mesh = _mesh(shape)
        with mesh, shd.activation_sharding(mesh, shd.make_rules(mesh)):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        y_local, aux_local = jax.jit(
            lambda p, x: moe.moe_ffn(p, x, cfg, return_aux=True))(p, x)
        # the dispatch's kept flags, as the layout decides them
        e, k = cfg.num_experts, cfg.experts_per_token
        t = b * s
        dp, mp = shape
        xf = x.reshape(t, -1)
        _, ids, _ = moe._route(p, xf, cfg)
        sharded = e % mp == 0 and t % dp == 0
        blocks = dp if sharded else 1
        cap = moe.capacity_for(t // blocks, cfg)
        dropped = 0
        for i in range(blocks):
            lo, hi = i * t // blocks, (i + 1) * t // blocks
            _, _, kept = moe._dispatch_local(xf[lo:hi], ids[lo:hi], cap, e, k)
            dropped += int((~kept).sum())
        out[case] = {
            "out": np.asarray(y), "aux": float(aux),
            "grads": {"x": np.asarray(gx), **_flat(gp)},
            "stats": (t * k, dropped), "sharded": sharded,
            "local_out": np.asarray(y_local),
            "local_aux": float(aux_local)}
    return out


def _train_setup(arch, over=None):
    """(JAX model, JAX params, axes, port config) from the port's init."""
    import jax
    import jax.numpy as jnp
    import torch

    import torch_model_ranks as W
    from repro.configs import get_reduced
    from repro.models.model import Model as JModel
    from repro_torch.models import Model

    over = over or {}
    tcfg = W.train_cfg(arch) if not over else \
        W.get_reduced(arch).replace(**over)
    tm = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(W.SEED))
    params = jax.tree.map(jnp.asarray, W.jax_style_tree(tm))
    jcfg = get_reduced(arch).replace(dtype=tcfg.dtype)
    return JModel(jcfg), params, tm.axes(), tcfg


def _place(tree, axes, mesh):
    import jax

    from repro.dist import sharding as shd

    return jax.device_put(tree, shd.tree_shardings(
        tree, axes, mesh, shd.make_rules(mesh)))


def _flat_params(params, axes, cfg) -> dict:
    import jax
    import numpy as np

    from repro_torch.convert import model_params_from_jax

    got = model_params_from_jax(jax.tree.map(np.asarray, params), axes, cfg)
    return {k: v.numpy() for k, v in got.items()}


def _optimizer(cfg):
    """The package's AdamW, its update also returning the gradients it was
    given among the metrics (``"grads"``)."""
    from repro.train.optimizer import AdamW

    class Recording(AdamW):
        def update(self, params, grads, state):
            params, state, m = super().update(params, grads, state)
            return params, state, {**m, "grads": grads}

    return Recording(cfg)


def _steps(step, params, opt_state, batches, mesh, axes, cfg):
    """The steps on ``mesh`` → (params, opt_state, losses, grad norms,
    each step's gradients as the port's flat leaves)."""
    from repro.dist import sharding as shd

    losses, gnorms, grads = [], [], []
    with mesh, shd.activation_sharding(mesh, shd.make_rules(mesh)):
        for batch in batches:
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            grads.append(_flat_params(m["grads"], axes, cfg))
    return params, opt_state, losses, gnorms, grads


def train_oracle(grids) -> dict:
    import jax

    import torch_model_ranks as W
    from repro.train.data import SyntheticLM
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step

    out = {}
    for grid in grids:
        mesh = _mesh(W.TRAIN_GRIDS[grid])
        for arch in W.TRAIN_ARCHS:
            jm, params, axes, tcfg = _train_setup(arch)
            opt = _optimizer(AdamWConfig(**W.TRAIN_OPT))
            params = _place(params, axes, mesh)
            opt_state = _place(opt.init(params), opt.state_axes(axes), mesh)
            data = SyntheticLM(tcfg.vocab_size, W.TRAIN_S, W.TRAIN_B,
                               seed=W.DATA_SEED)
            step = jax.jit(make_train_step(jm, opt,
                                           microbatches=W.TRAIN_MB))
            params, _, losses, gnorms, grads = _steps(
                step, params, opt_state,
                [data.next_batch() for _ in range(W.TRAIN_STEPS)], mesh,
                axes, tcfg)
            out[grid, arch] = {"losses": losses, "grad_norms": gnorms,
                               "grads": grads,
                               "params": _flat_params(params, axes, tcfg)}
    return out


def kill_oracle() -> dict:
    """tests/torch_model_ranks.py's KILL_ARGV through the JAX package's
    pieces: steps on a (2, 2) mesh, ``launch.train.remesh_live_state``
    onto the first 3 devices (a (1, 2) mesh), the rest of the steps."""
    import jax

    import torch_model_ranks as W
    from repro.launch.train import remesh_live_state
    from repro.train.data import SyntheticLM
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step

    argv = W.KILL_ARGV
    arg = {argv[i]: argv[i + 1] for i in range(len(argv) - 1)
           if argv[i].startswith("--")}
    steps, kill = int(arg["--steps"]), int(arg["--kill-device-at"])
    b, s, mb = int(arg["--batch"]), int(arg["--seq"]), int(
        arg["--microbatches"])
    jm, params, axes, tcfg = _train_setup(
        arg["--arch"], {"dtype": arg["--dtype"]})
    opt = _optimizer(AdamWConfig(peak_lr=1e-3, total_steps=steps,
                                 warmup_steps=max(steps // 20, 1)))
    mesh = _mesh((2, 2))
    params = _place(params, axes, mesh)
    opt_state = _place(opt.init(params), opt.state_axes(axes), mesh)
    data = SyntheticLM(tcfg.vocab_size, s, b, seed=0)
    step = jax.jit(make_train_step(jm, opt, microbatches=mb))
    params, opt_state, losses, gnorms, grads = _steps(
        step, params, opt_state, [data.next_batch() for _ in range(kill)],
        mesh, axes, tcfg)
    before = _flat_params(params, axes, tcfg)
    mesh, _, params, opt_state = remesh_live_state(
        params, opt_state, axes, opt.state_axes(axes),
        list(mesh.devices.flat)[:-1])
    step = jax.jit(make_train_step(jm, opt, microbatches=mb))
    params, opt_state, more, more_g, more_grads = _steps(
        step, params, opt_state,
        [data.next_batch() for _ in range(steps - kill)], mesh, axes, tcfg)
    return {"losses": losses + more, "grad_norms": gnorms + more_g,
            "grads": grads + more_grads,
            "mesh": dict(mesh.shape), "before": before,
            "params": _flat_params(params, axes, tcfg)}


def _pspec(sharding) -> tuple:
    """A NamedSharding's spec as the port writes one."""
    return tuple(sharding.spec)


def _port_specs(specs, axes) -> dict:
    """The JAX specs tree as the port's flat ``state_dict`` names: a
    stacked leaf's spec without its leading layers entry (trailing Nones
    trimmed, as the port's are)."""
    out = {}

    def walk(s, a, path):
        if isinstance(s, dict):
            for k in s:
                walk(s[k], a[k], path + (k,))
            return
        spec = list(_pspec(s))
        if a and a[0] == "layers":
            spec = spec[1:]
            while spec and spec[-1] is None:
                spec.pop()
            for i in range(_DEPTH[path[0]]):
                out[".".join((path[0], str(i)) + path[1:])] = tuple(spec)
        else:
            out[".".join(path)] = tuple(spec)

    walk(specs, axes, ())
    return out


_DEPTH: dict = {}


def dense_oracle(grids) -> dict:
    """tests/torch_model_ranks.py's dense cases on each grid's 8-device
    Auto mesh: the params' specs (``tree_shardings`` under each rule
    table), the forward's logits and loss, the prefill's logits and cache,
    the greedy tokens, and two jitted AdamW steps (losses, grad norms,
    the gradients each update was given, the parameters after)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import torch_model_ranks as W
    from repro.dist import sharding as shd
    from repro.train.optimizer import AdamWConfig
    from repro.train.serve import make_decode_step
    from repro.train.step import make_train_step

    out = {}
    for grid in grids:
        mesh = _mesh(W.DENSE_GRIDS[grid])
        archs = W.DENSE_CASES[grid]
        for arch in archs:
            jm, params, axes, tcfg = _train_setup(arch, {"dtype": "float32"})
            _DEPTH.update(layers=tcfg.num_layers, decoder=tcfg.num_layers,
                          encoder=tcfg.num_encoder_layers)
            strategies = ["2d"]
            if (grid, arch) == W.DENSE_STRATEGY_CASE:
                strategies += ["fsdp", "serve"]
            rec = {"specs": {
                st: _port_specs(shd.tree_shardings(
                    params, axes, mesh, shd.make_rules(mesh, strategy=st)),
                    axes) for st in strategies}}
            inputs = {k: jnp.asarray(v)
                      for k, v in W.dense_inputs(tcfg, W.DENSE_B, 7).items()}
            serve = {k: v for k, v in inputs.items() if k != "labels"}
            placed = _place(params, axes, mesh)
            with mesh, shd.activation_sharding(mesh, shd.make_rules(mesh)):
                logits, loss = jax.jit(lambda p, b: (
                    jm.forward(p, b)[0], jm.train_loss(p, b)))(placed, inputs)
                pl, cache = jax.jit(lambda p, b: jm.prefill(
                    p, b, cache_len=W.DENSE_S + W.DENSE_GEN))(placed, serve)
                # the package's generate(), its prefill's result reused
                decode = jax.jit(make_decode_step(jm))
                tok = jnp.argmax(pl[:, -1, :], axis=-1).astype(
                    jnp.int32)[:, None]
                toks, c = [tok], cache
                for i in range(W.DENSE_GEN - 1):
                    tok, c, _ = decode(placed, c, tok, W.DENSE_S + i)
                    toks.append(tok)
                toks = jnp.concatenate(toks, axis=1)
            rec["serve"] = {"logits": np.asarray(logits),
                            "loss": float(loss), "prefill": np.asarray(pl),
                            "cache": {k: np.asarray(v)
                                      for k, v in cache.items()},
                            "tokens": np.asarray(toks)}
            opt = _optimizer(AdamWConfig(**W.TRAIN_OPT))
            opt_state = _place(opt.init(placed), opt.state_axes(axes), mesh)
            step = jax.jit(make_train_step(jm, opt))
            batches = [{k: jnp.asarray(v) for k, v in b.items()}
                       for b in W.train_batches(tcfg)]
            losses, gnorms, grads, after = [], [], [], []
            for batch in batches:  # the parameters after each step
                placed, opt_state, ls, gn, gr = _steps(
                    step, placed, opt_state, [batch], mesh, axes, tcfg)
                losses += ls
                gnorms += gn
                grads += gr
                after.append(_flat_params(placed, axes, tcfg))
            # the first step's gradients on one device, unsharded: JAX's
            # own float32 distance between two layouts of the same sums
            _, _, m = jax.jit(make_train_step(jm, opt))(
                params, opt.init(params), batches[0])
            rec["train"] = {"losses": losses, "grad_norms": gnorms,
                            "grads": grads, "params": after,
                            "grads_one_device": _flat_params(
                                m["grads"], axes, tcfg)}
            out[grid, arch] = rec
    return out


def hlo_oracle(cells) -> dict:
    """The JAX dry run's account of reduced cells on a (4, 2) 8-device
    Auto mesh under ``make_rules`` (tests/test_torch_dryrun_grid.py):
    each cell ``arch:kind`` of ``GRID_B`` rows of ``GRID_S`` tokens
    jitted with the rules' in-shardings → ``hlo_analysis.analyze``'s dot
    FLOPs a device and ``memory_analysis``'s argument bytes."""
    import dataclasses

    import jax

    from repro.configs import SHAPES, get_reduced
    from repro.dist import sharding as shd
    from repro.launch import hlo_analysis
    from repro.launch import specs as jspecs
    from repro.models.model import Model as JModel
    from repro.train.optimizer import AdamW, AdamWConfig
    from repro.train.serve import make_decode_step
    from repro.train.step import make_train_step

    import test_torch_dryrun_grid as T

    mesh = _mesh(T.GRID_SHAPE)
    rules = shd.make_rules(mesh)
    out = {}
    for cell in cells:
        arch, kind, *dtype = cell.split(":")
        cfg = get_reduced(arch)
        if dtype:
            cfg = cfg.replace(dtype=dtype[0])
        shape = dataclasses.replace(SHAPES[T.SHAPE_OF[kind]],
                                    global_batch=T.GRID_B, seq_len=T.GRID_S)
        model = JModel(cfg)
        pspec = jspecs.params_specs(cfg)
        p_sh = shd.tree_shardings(pspec.args, pspec.axes, mesh, rules)
        if kind == "train":
            opt = AdamW(AdamWConfig())
            opt_shapes = jax.eval_shape(opt.init, pspec.args)
            o_sh = shd.tree_shardings(opt_shapes, opt.state_axes(pspec.axes),
                                      mesh, rules)
            bspec = jspecs.batch_specs(cfg, shape, with_labels=True)
            b_sh = shd.tree_shardings(bspec.args, bspec.axes, mesh, rules)
            fn = jax.jit(make_train_step(model, opt),
                         in_shardings=(p_sh, o_sh, b_sh))
            args = (pspec.args, opt_shapes, bspec.args)
        else:
            dec = jspecs.decode_specs(cfg, shape)
            c_sh = shd.tree_shardings(dec["cache"].args, dec["cache"].axes,
                                      mesh, rules)
            t_sh = shd.sharding_for(dec["token"].args.shape,
                                    dec["token"].axes, mesh, rules)
            step = make_decode_step(model)
            fn = jax.jit(lambda p, c, t, pos: step(p, c, t, pos)[:2],
                         in_shardings=(p_sh, c_sh, t_sh, None))
            args = (pspec.args, dec["cache"].args, dec["token"].args,
                    dec["pos"].args)
        with mesh, shd.activation_sharding(mesh, rules):
            compiled = fn.lower(*args).compile()
        hlo = compiled.as_text()
        st = hlo_analysis.analyze(hlo, world=mesh.size)
        out[cell] = {"dot_flops": st.dot_flops,
                     "argument_bytes":
                         compiled.memory_analysis().argument_size_in_bytes,
                     "collective_by_kind": st.collective_by_kind,
                     "collective_by_group": _collectives_by_group(
                         hlo, mesh.size)}
    return out


def _collectives_by_group(hlo: str, world: int) -> dict:
    """``(kind, group size)`` → per-device wire bytes of an HLO module's
    collectives, as ``hlo_analysis.analyze`` counts each (its loop
    multipliers and ring wire model; no bf16 promotion correction: the
    cells that read this compute in float32)."""
    from repro.launch import hlo_analysis as H

    comps = H.parse_computations(hlo)
    mult = H.computation_multipliers(hlo, comps)
    out: dict = {}
    for name, comp in comps.items():
        m = mult.get(name, 1.0) or 1.0
        for line in comp.lines:
            mc = H._COLLECTIVE_RE.search(line)
            if mc is None:
                continue
            kind = mc.group(1)
            rhs = line.split("=", 1)[1]
            g = H._group_size(line, world=world)
            wire = H._wire_bytes(kind, H.shape_bytes(rhs[:rhs.find(kind)]),
                                 g) * m
            out[kind, g] = out.get((kind, g), 0.0) + wire
    return out


def main(argv):
    _setup()
    mode, dest, *rest = argv
    got = {"moe": moe_oracle, "kill": kill_oracle,
           "train": lambda: train_oracle(rest),
           "dense": lambda: dense_oracle(rest),
           "hlo": lambda: hlo_oracle(rest)}[mode]()
    with open(dest, "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1:])
