"""End-to-end training driver, as in the JAX package's ``launch/train.py``,
on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 200 --batch 8 --seq 128 --checkpoint-dir CKPT

The parameters are made from ``--seed`` on the device; the data is
``train.data.SyntheticLM`` (seed ``--seed``), with frames for the
encoder-decoder and patch embeddings for the vlm family drawn from a
generator seeded by the step (so a resumed run draws the same ones).
Checkpoints every ``--checkpoint-every`` steps with auto-resume (the data
cursor included).  ``--device cpu`` runs the kernels' plain versions;
``--dtype`` overrides the config's compute dtype.  Each logged line ends
with the card's name and power limit as ``nvidia-smi`` gives them.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks form a
``dist.sharding.RankGrid`` of (W / mp, mp) over ("data", "model"),
``--model-parallel`` mp (default: 2 when W is even, as the JAX package's
``make_host_mesh``), under the ``"2d"`` rules (FSDP on data × TP on
model, as the JAX package's launcher): each rank holds
its block of every parameter and of the optimizer state, draws the global
batch and keeps its rows, and the gradients' parts are summed
(``train.step``)::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --reduced --steps 6 --kill-device-at 3

(``--backend gloo``, the default, lets the ranks share one card; ``nccl``
wants a card a rank.)  ``--kill-device-at K`` keeps the JAX package's
checkpoint-free elasticity, whose kill is simulated (XLA's resharding
reads every old shard, the killed device's included): at step K the grid
loses its last rank and :func:`remesh_live_state` re-plans it from the
survivors with ``dist.fault.elastic_plan`` (the model axis kept, the data
axis shrunk).  The lost rank hands its blocks of the parameters and the
optimizer state over before it goes idle: every rank of the old grid
gathers each leaf whole and keeps its block on the survivor grid
(``Model.remesh``), so the FSDP dims are re-laid over the new data axis;
the step count is kept and the data rows split again.  This is not a
recovery from lost memory.  The ranks past the survivor grid sit out and
return the leader's losses.  On one card the mesh is (data=1, model=1): no device survives,
and the plan raises ``ValueError``.  Checkpoints and ``--grad-wire`` across
ranks are not ported (ROADMAP Queue A items 13d.8 and 13d.9).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.dist import fault
from repro_torch.dist import sharding as shd
from repro_torch.launch.graph_serve import card_line
from repro_torch.launch.mesh import make_host_mesh, make_rank_grid, world_size
from repro_torch.models.model import Model
from repro_torch.plug.protocols import not_ported_error
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.step import as_batch, init_wire_state, make_train_step

def remesh_live_state(mesh, survivors):
    """Checkpoint-free migration onto the survivors: the survivor mesh is
    planned with ``dist.fault.elastic_plan``, the model axis preserved.

    On a ``RankGrid`` ``survivors`` are the world ranks still alive; the
    plan's grid takes the first of them (``RankGrid.survivors``, which
    every world rank calls) and is returned.  Rank (d, r) of it is world
    rank d·mp + r, as before the loss; the caller re-lays the parameters
    and the optimizer state onto it (``Model.remesh``).  On the
    one-card host mesh the plan is all there is to it: it raises
    ``ValueError`` when the survivors cannot host one model replica (one
    card: none survives); it is returned otherwise."""
    plan = fault.elastic_plan(len(survivors),
                              model_parallel=mesh.shape["model"])
    grid = shd.grid_of(mesh)
    if grid is None:
        return plan
    if list(survivors)[:plan.size] != list(range(plan.size)):
        raise ValueError(f"the survivor grid takes world ranks "
                         f"0..{plan.size - 1}; survivors {list(survivors)}")
    return grid.survivors(plan)


def extra_inputs(cfg, batch: int, step: int, seed: int, device) -> dict:
    """The stub frontends' inputs for one step: frames (encdec) or patch
    embeddings (vlm), 0.02·N(0, 1) from a generator seeded by the step."""
    shape = {"encdec": ("frames", cfg.encoder_seq),
             "vlm": ("patch_embeds", cfg.num_patches)}.get(cfg.family)
    if shape is None:
        return {}
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)
    return {shape[0]: 0.02 * torch.randn((batch, shape[1], cfg.d_model),
                                         generator=gen, device=device)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kill-device-at", type=int, default=None,
                    help="lose the mesh's last device at this step: elastic "
                         "re-plan onto the survivors")
    ap.add_argument("--grad-wire", choices=("none", "int8"), default="none",
                    help="put the gradient through the int8 error-feedback "
                         "wire round of dist.collectives before the "
                         "optimizer (residuals live with the run, not the "
                         "checkpoint)")
    ap.add_argument("--grad-wire-bits", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    choices=(None, "bfloat16", "float32"),
                    help="the compute dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="the grid's model axis under torchrun")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the process group's backend under torchrun")
    return ap.parse_args(argv)


def main(argv=None):
    """Parses ``argv`` and trains (:func:`train`); returns the losses."""
    return train(parse_args(argv))["losses"]


def train(args) -> dict:
    """Runs the training ``args`` describe → ``{"losses", "model",
    "grid"}`` (``grid``: the RankGrid the rank ended on, None on one
    process).  An idle rank's losses are the leader's."""
    ranks = world_size() > 1
    if ranks and args.checkpoint_dir:
        raise not_ported_error("launch.train --checkpoint-dir across ranks",
                               "13d.8")
    if ranks and args.grad_wire != "none":
        raise not_ported_error("launch.train --grad-wire across ranks",
                               "13d.9")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if ranks:
        grid = make_rank_grid(args.model_parallel, args.backend,
                              device=args.device, strategy="2d")
        dev, mesh = grid.device, grid
        rules = grid.rules
    else:
        grid = None
        dev = resolve_device(args.device)
        mesh = make_host_mesh()
        rules = shd.make_rules(mesh)
    model = Model(cfg, device=dev, mesh=grid).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = AdamW(AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1)))
    opt_state = opt.init(model)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    card = card_line(args.device)
    lead = grid is None or grid.rank == grid.leader
    # the leader's post of the losses, named alike on every rank by the
    # run's arguments
    run_key = f"launch.train/{sorted(vars(args).items())}/losses"

    start_step = 0
    manager = None
    if args.checkpoint_dir:
        manager = ckpt.CheckpointManager(args.checkpoint_dir,
                                         every=args.checkpoint_every)
        restored = manager.restore_or_none(like_params=model,
                                           like_opt=opt_state)
        if restored:
            model.load_state_dict(restored["params"])
            opt_state = restored["opt_state"]
            data.load_state_dict(restored["data_state"])
            start_step = restored["step"]
            print(f"resumed from step {start_step}", flush=True)

    wire = None if args.grad_wire == "none" else args.grad_wire
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              grad_wire=wire,
                              grad_wire_bits=args.grad_wire_bits)
    wire_state = init_wire_state(model) if wire else None
    losses, step_s = [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()

    def run_steps(lo, hi, mesh, rules, opt_state, wire_state):
        with shd.activation_sharding(mesh, rules):
            for step in range(lo, hi):
                t_step = time.perf_counter()
                batch = as_batch(data.next_batch(), dev)
                batch.update(extra_inputs(cfg, args.batch, step, args.seed,
                                          dev))
                if wire_state is None:
                    opt_state, metrics = step_fn(opt_state, batch)
                else:
                    opt_state, wire_state, metrics = step_fn(
                        opt_state, wire_state, batch)
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t_step)
                if lead and (step % args.log_every == 0
                             or step == args.steps - 1):
                    dt = time.perf_counter() - t0
                    wire_err = (f" wire_err {float(metrics['grad_wire_err']):.3e}"
                                if wire_state is not None else "")
                    print(f"step {step:5d} loss {losses[-1]:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.3f}"
                          f"{wire_err} ({dt:.1f}s) on {card}", flush=True)
                if manager:
                    manager.maybe_save(step + 1, params=model,
                                       opt_state=opt_state,
                                       data_state=data.state_dict())
        return opt_state, wire_state

    kill = args.kill_device_at
    migrate_s = None
    if kill is not None and start_step < kill < args.steps:
        opt_state, wire_state = run_steps(start_step, kill, mesh, rules,
                                          opt_state, wire_state)
        devices = list(range(grid.size)) if grid is not None else [dev]
        t_mig = time.perf_counter()
        new = remesh_live_state(mesh, devices[:-1])  # lose the last one
        if grid is None:  # the one-card plan (raised above if none fits)
            print(f"step {kill:5d} device lost → survivor mesh "
                  f"{new.shape}", flush=True)
        else:
            model.remesh(new, opt_state)  # every old rank, the lost one too
            grid = mesh = new
            rules = grid.rules
            migrate_s = time.perf_counter() - t_mig
            if lead:
                print(f"step {kill:5d} device lost → survivor mesh "
                      f"{dict(grid.shape)} over {grid.size}/"
                      f"{len(devices)} devices, live state migrated "
                      f"checkpoint-free ({migrate_s:.2f}s) on {card}",
                      flush=True)
        if grid is None or not grid.idle:
            opt_state, wire_state = run_steps(kill, args.steps, mesh, rules,
                                              opt_state, wire_state)
    else:
        opt_state, wire_state = run_steps(start_step, args.steps, mesh,
                                          rules, opt_state, wire_state)
    if grid is not None:
        if lead:
            grid.post(run_key, losses)
        elif grid.idle:
            losses = grid.wait_post(run_key)
    elapsed = time.perf_counter() - t0
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if steps and lead:
        first = np.mean(losses[:5])
        last = np.mean(losses[-5:])
        where = "" if grid is None else f" on a {dict(grid.shape)} grid"
        print(f"{cfg.name}: {model.num_params():,} parameters{where}; "
              f"{steps} steps of {args.batch}×{args.seq} in {elapsed:.3f}s "
              f"({elapsed / steps:.3f} s a step, "
              f"{steps * args.batch * args.seq / elapsed:.1f} tok/s); peak "
              f"{peak / 2**30:.2f} GiB; loss: first5={first:.4f} "
              f"last5={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'}) on {card}",
              flush=True)
    return {"losses": losses, "model": model, "grid": grid,
            "step_s": step_s, "migrate_s": migrate_s}


if __name__ == "__main__":
    main()
