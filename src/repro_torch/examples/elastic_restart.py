"""Elasticity end to end, the twin of ``examples/elastic_restart.py``:
train → a host fails → ``FleetMonitor.remesh`` → restore → resume.

A 4-host fleet trains a reduced stablelm for 10 steps while host 2
straggles (Lemma-2 batch fractions), checkpoints, then loses host 2; the
monitor re-plans the mesh from the survivors, the checkpoint is restored
into a fresh model and training resumes for 10 steps with the data cursor
intact — no replayed or skipped batch (each survivor's ``ShardedLoader``
shard is a slice of the same global batch).  The result is held against
an uninterrupted 20-step run: on the CPU bit for bit ("EXACT RESUME"); on
the card the embedding's gradient sums with atomics, so the runs agree
only within ``LOSS_RTOL`` in the loss.

  PYTHONPATH=src python -m repro_torch.examples.elastic_restart
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.dist import fault
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import ShardedLoader, SyntheticLM
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.step import make_train_step

#: |loss − uninterrupted loss| ≤ LOSS_RTOL·|loss| at every resumed step
LOSS_RTOL = 1e-3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shutil.rmtree(args.checkpoint_dir, ignore_errors=True)
    cfg = get_reduced("stablelm-1.6b").replace(dtype="float32",
                                               param_dtype="float32")
    opt = AdamW(AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=40))

    def fresh():
        return Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))

    def run(model, state, data, steps, losses):
        step = make_train_step(model, opt)
        for _ in range(steps):
            state, m = step(state, data.next_batch())
            losses.append(float(m["loss"]))
        return state

    # --- phase 1: a 4-host fleet, host 2 straggling ------------------------
    monitor = fault.FleetMonitor(num_hosts=4, model_parallel=1)
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8, seed=7)
    model = fresh()
    losses: list = []
    state = run(model, opt.init(model), data, 10, losses)
    for _ in range(10):
        for h, t in enumerate([1.0, 1.05, 2.6, 0.95]):
            monitor.record(h, t)
    ckpt.save(args.checkpoint_dir, 10, params=model, opt_state=state,
              data_state=data.state_dict())
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = {f"{part}/{k}": v.clone() for part in ("m", "v")
                 for k, v in state[part].items()}
    saved_opt["step"] = state["step"].clone()
    frac = monitor.batch_fractions()
    print(f"phase 1: loss={losses[-1]:.3f}; straggler mask "
          f"{monitor.stragglers().tolist()}; Lemma-2 batch fractions "
          f"{np.round(frac, 3).tolist()}")

    # --- phase 2: host 2 dies; re-mesh, restore, resume --------------------
    monitor.mark_failed(2)
    plan = monitor.remesh(devices_per_host=128)  # 4×128 → 3×128 survivors
    print(f"phase 2: host 2 failed → re-mesh plan {plan.shape} "
          f"({plan.devices_used} devices)")
    model2 = fresh()
    restored = ckpt.restore(args.checkpoint_dir, like_params=model2,
                            like_opt=opt.init(model2))
    model2.load_state_dict(restored["params"])
    opt2 = restored["opt_state"]
    restored_equal = all(torch.equal(v, saved[k]) for k, v in
                         model2.state_dict().items()) and all(
        torch.equal(v, opt2["step"] if k == "step" else
                    opt2[k.split("/")[0]][k.split("/", 1)[1]])
        for k, v in saved_opt.items())

    def stream():
        out = SyntheticLM(cfg.vocab_size, 32, 8)
        out.load_state_dict(restored["data_state"])
        return out

    # each survivor restores the cursor and materializes its slice of the
    # same global batch
    shards = [ShardedLoader(stream(), host_id=h, num_hosts=3).next_batch()
              for h in range(3)]
    sharded_ok = np.array_equal(
        np.concatenate([b["tokens"] for b in shards]),
        stream().next_batch()["tokens"])
    data2 = stream()
    resumed: list = []
    run(model2, opt2, data2, 10, resumed)
    print(f"phase 3: resumed steps 10→20 on survivors; loss="
          f"{resumed[-1]:.3f}")

    # --- verify: against an uninterrupted run ------------------------------
    data_ref = SyntheticLM(cfg.vocab_size, 32, 8, seed=7)
    model_ref = fresh()
    ref_losses: list = []
    run(model_ref, opt.init(model_ref), data_ref, 20, ref_losses)
    ref = model_ref.state_dict()
    diff = max(float((v - ref[k]).abs().max())
               for k, v in model2.state_dict().items())
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(resumed, ref_losses[10:]))
    verdict = ("EXACT RESUME" if diff == 0 else
               "RESUME WITHIN TOLERANCE" if loss_err <= LOSS_RTOL else
               "mismatch!")
    print(f"verification: restored parameters and optimizer state "
          f"bit-equal to the saved ones: "
          f"{restored_equal}; max |param diff| vs uninterrupted run = "
          f"{diff:.2e}; max relative loss difference {loss_err:.2e} "
          f"({verdict})")
    return {"plan": list(plan.shape), "restored_bit_equal": restored_equal,
            "sharded_loader_slices": bool(sharded_ok),
            "max_param_diff": diff, "max_loss_rel_diff": loss_err,
            "loss_rtol": LOSS_RTOL, "resumed_losses": resumed,
            "uninterrupted_losses": ref_losses[10:], "verdict": verdict}


if __name__ == "__main__":
    main()
