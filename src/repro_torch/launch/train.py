"""End-to-end training driver, as in the JAX package's ``launch/train.py``,
on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 200 --batch 8 --seq 128 --checkpoint-dir CKPT

The parameters are made from ``--seed`` on the device; the data is
``train.data.SyntheticLM`` (seed ``--seed``), with frames for the
encoder-decoder and patch embeddings for the vlm family drawn from a
generator seeded by the step (so a resumed run draws the same ones).
Checkpoints every ``--checkpoint-every`` steps with auto-resume (the data
cursor included).  ``--kill-device-at K`` keeps the JAX package's
checkpoint-free elasticity: at step K the mesh loses its last device and
:func:`remesh_live_state` re-plans it from the survivors with
``dist.fault.elastic_plan``.  The host mesh is one card (data=1,
model=1), so no device survives and the plan raises ``ValueError``; a kill
with survivors needs a mesh across cards (ROADMAP Queue A item 13d): under
``torchrun`` (``WORLD_SIZE`` > 1) ``--kill-device-at`` raises.
``--device cpu`` runs the kernels' plain versions.  Each logged line ends
with the card's name and power limit as ``nvidia-smi`` gives them.
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
from repro_torch.launch.mesh import make_host_mesh, world_size
from repro_torch.models.model import Model
from repro_torch.plug.protocols import not_ported_error
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.step import as_batch, init_wire_state, make_train_step


def remesh_live_state(mesh, survivors):
    """Checkpoint-free migration onto the survivors: the survivor mesh is
    planned with ``dist.fault.elastic_plan``, the model axis preserved.
    On one card the live parameters and optimizer state stay where they
    are, so the plan is all there is to it; it raises ``ValueError`` when
    the survivors cannot host one model replica (one card: none survives).
    Returns the plan."""
    return fault.elastic_plan(len(survivors),
                              model_parallel=mesh.shape["model"])


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


def main(argv=None):
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.kill_device_at is not None and world_size() > 1:
        raise not_ported_error("launch.train --kill-device-at with survivors "
                               "across ranks", 13)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    mesh = make_host_mesh()
    rules = shd.make_rules(mesh)
    opt = AdamW(AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1)))
    opt_state = opt.init(model)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    card = card_line(args.device)

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
    losses = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()

    def run_steps(lo, hi, opt_state, wire_state):
        with shd.activation_sharding(mesh, rules):
            for step in range(lo, hi):
                batch = as_batch(data.next_batch(), dev)
                batch.update(extra_inputs(cfg, args.batch, step, args.seed,
                                          dev))
                if wire_state is None:
                    opt_state, metrics = step_fn(opt_state, batch)
                else:
                    opt_state, wire_state, metrics = step_fn(
                        opt_state, wire_state, batch)
                losses.append(float(metrics["loss"]))
                if step % args.log_every == 0 or step == args.steps - 1:
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
    if kill is not None and start_step < kill < args.steps:
        opt_state, wire_state = run_steps(start_step, kill, opt_state,
                                          wire_state)
        devices = [dev]  # the host mesh: one card
        plan = remesh_live_state(mesh, devices[:-1])
        print(f"step {kill:5d} device lost → survivor mesh {plan.shape}",
              flush=True)
        opt_state, wire_state = run_steps(kill, args.steps, opt_state,
                                          wire_state)
    else:
        opt_state, wire_state = run_steps(start_step, args.steps, opt_state,
                                          wire_state)
    elapsed = time.perf_counter() - t0
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if steps:
        first = np.mean(losses[:5])
        last = np.mean(losses[-5:])
        print(f"{cfg.name}: {model.num_params():,} parameters; {steps} steps "
              f"of {args.batch}×{args.seq} in {elapsed:.3f}s "
              f"({elapsed / steps:.3f} s a step, "
              f"{steps * args.batch * args.seq / elapsed:.1f} tok/s); peak "
              f"{peak / 2**30:.2f} GiB; loss: first5={first:.4f} "
              f"last5={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'}) on {card}",
              flush=True)
    return losses


if __name__ == "__main__":
    main()
