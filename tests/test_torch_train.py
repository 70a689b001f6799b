"""The port's train stack (``repro_torch.train``, ``launch.train`` and the
example twins) on the CPU: the twins of ``tests/test_train.py``'s tests
and of ``tests/test_system.py::test_elastic_failure_resume_is_exact``,
with the optimizer, the microbatch choice and the data pipeline held
against the JAX package's.

Tolerances: the port's ``apply_updates`` against JAX's on equal float32
parameters and gradients within 1e-6 (absolute, O(1) values; float32 in
other operation orders); against the naive NumPy AdamW rtol 1e-5 (as
tests/test_train.py); microbatch equivalence loss rel 1e-5 and parameters
atol 1e-5 (as there); data batches byte-equal; checkpoint round trips and
resumes bit for bit.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import get_reduced
from repro_torch.dist import fault
from repro_torch.examples import elastic_restart, serve_lm, train_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import ShardedLoader, SyntheticLM
from repro_torch.train.optimizer import (AdamW, AdamWConfig, apply_updates,
                                         init_opt_state, schedule)
from repro_torch.train.step import (eval_step, make_train_step,
                                    suggest_microbatches)


def _tiny_model(seed=0):
    cfg = get_reduced("stablelm-1.6b").replace(num_layers=2, dtype="float32",
                                               param_dtype="float32")
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


def _params_grads(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((3,)).astype(np.float32)}
    return params, grads


def test_adamw_matches_naive_reference_and_jax():
    params, grads = _params_grads()
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                      min_lr_ratio=1.0, weight_decay=0.1, grad_clip=1e9)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = init_opt_state(tp, cfg)
    state, metrics = apply_updates(tp, {k: torch.from_numpy(v) for k, v in
                                        grads.items()}, state, cfg)
    for k in params:  # naive numpy AdamW, step 1
        g = grads[k]
        m, v = (1 - cfg.b1) * g, (1 - cfg.b2) * g * g
        delta = (m / (1 - cfg.b1)) / (np.sqrt(v / (1 - cfg.b2)) + cfg.eps)
        if params[k].ndim >= 2:
            delta = delta + cfg.weight_decay * params[k]
        np.testing.assert_allclose(tp[k].numpy(), params[k] - 1e-2 * delta,
                                   rtol=1e-5)
    assert int(state["step"]) == 1

    # against JAX's apply_updates, three steps, with warmup, decay and clip
    jcfg = jopt.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=6,
                            grad_clip=0.5)
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=6,
                      grad_clip=0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_opt_state(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = init_opt_state(tp, cfg)
    for i in range(3):
        _, g = _params_grads(i + 1)
        jp, js, jm = jopt.apply_updates(jp, {k: jnp.asarray(v) for k, v in
                                             g.items()}, js, jcfg)
        ts, tm = apply_updates(tp, {k: torch.from_numpy(v) for k, v in
                                    g.items()}, ts, cfg)
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0)
            for part in ("m", "v"):
                np.testing.assert_allclose(ts[part][k].numpy(),
                                           np.asarray(js[part][k]),
                                           atol=1e-6, rtol=0)
    for step in range(0, 8):  # the schedule, step for step
        assert float(schedule(cfg, torch.tensor(step))) == float(
            jopt.schedule(jcfg, jnp.asarray(step)))


def test_grad_clip_caps_update():
    params = {"w": torch.ones((8, 8))}
    grads = {"w": 1e6 * torch.ones((8, 8))}
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, grad_clip=1.0,
                      weight_decay=0.0)
    state = init_opt_state(params, cfg)
    _, metrics = apply_updates(params, grads, state, cfg)
    assert float(metrics["grad_norm"]) > 1e6  # reported pre-clip
    assert float((params["w"] - 1).abs().max()) <= 1e-2 * (1 + 1e-6)


def test_bf16_state_dtype_halves_the_moments():
    model = _tiny_model()
    opt = AdamW(AdamWConfig(state_dtype="bfloat16"))
    state = opt.init(model)
    assert all(t.dtype == torch.bfloat16 for t in state["m"].values())
    data = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=2)
    state, metrics = make_train_step(model, opt)(state, data.next_batch())
    assert state["v"]["embed.table"].dtype == torch.bfloat16
    assert np.isfinite(float(metrics["loss"]))


def test_microbatch_equivalence():
    """mb=1 vs mb=4 give (numerically) the same update."""
    data = SyntheticLM(256, seq_len=16, global_batch=8)
    batch = data.next_batch()
    opt = AdamW(AdamWConfig(peak_lr=1e-3, warmup_steps=0))
    outs = {}
    for mb in (1, 4):
        model = _tiny_model()
        _, metrics = make_train_step(model, opt, microbatches=mb)(
            opt.init(model), batch)
        outs[mb] = (model.state_dict(), float(metrics["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-5)
    for k, v in outs[1][0].items():
        np.testing.assert_allclose(v.numpy(), outs[4][0][k].numpy(),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        model = _tiny_model()
        make_train_step(model, opt, microbatches=3)(opt.init(model), batch)


def test_loss_decreases():
    model = _tiny_model()
    opt = AdamW(AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40))
    state = opt.init(model)
    step = make_train_step(model, opt)
    data = SyntheticLM(model.cfg.vocab_size, seq_len=32, global_batch=8,
                       seed=1)
    losses = []
    for _ in range(40):
        state, metrics = step(state, data.next_batch())
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1
    assert all(not p.requires_grad for p in model.parameters())
    loss = eval_step(model)(data.next_batch())
    assert loss.grad_fn is None and np.isfinite(float(loss))


def test_suggest_microbatches_matches_jax():
    for gb in (1, 6, 8, 12, 96, 256):
        for per in (1 << 16, 1 << 20, 3 << 20):
            for budget in (1 << 20, 4 << 20, 1 << 30):
                n = suggest_microbatches(gb, bytes_per_sample=per,
                                         hbm_budget=budget)
                assert gb % n == 0 and n >= 1
                assert n == jstep.suggest_microbatches(
                    gb, bytes_per_sample=per, hbm_budget=budget)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    model = _tiny_model()
    opt = AdamW(AdamWConfig(peak_lr=1e-3))
    state = opt.init(model)
    data = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=3)
    step = make_train_step(model, opt)
    snap = None
    for i in range(4):  # 4 steps, a checkpoint at 2
        state, _ = step(state, data.next_batch())
        if i == 1:
            ckpt.save(str(tmp_path), 2, params=model, opt_state=state,
                      data_state=data.state_dict())
            saved = {k: v.clone() for k, v in model.state_dict().items()}
        if i == 3:
            snap = {k: v.clone() for k, v in model.state_dict().items()}

    # the layout: one .npy a leaf under the state_dict names, a manifest
    files = set(os.listdir(tmp_path / "step_00000002"))
    assert "manifest.json" in files
    assert "params__layers.0.attn.wq.npy" in files
    assert "opt_state__m__layers.0.attn.wq.npy" in files
    assert "opt_state__step.npy" in files

    model2 = _tiny_model(seed=9)
    restored = ckpt.restore(str(tmp_path), like_params=model2,
                            like_opt=opt.init(model2))
    assert restored["step"] == 2
    for k, v in restored["params"].items():
        assert torch.equal(v, saved[k]), k
    model2.load_state_dict(restored["params"])
    data2 = SyntheticLM(model.cfg.vocab_size, 16, 4)
    data2.load_state_dict(restored["data_state"])
    step2 = make_train_step(model2, opt)
    state2 = restored["opt_state"]
    for _ in range(2):
        state2, _ = step2(state2, data2.next_batch())
    for k, v in model2.state_dict().items():
        assert torch.equal(v, snap[k]), k


def test_checkpoint_retention_and_latest(tmp_path):
    model = _tiny_model()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    for s in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), s, params=model, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000030",
                                            "step_00000040"]
    assert ckpt.latest_step(str(tmp_path)) == 40
    (tmp_path / "step_00000050.tmp").mkdir()  # a save cut short
    assert ckpt.latest_step(str(tmp_path)) == 40
    manager = ckpt.CheckpointManager(str(tmp_path / "m"), every=3, keep=1)
    assert manager.restore_or_none(like_params=model) is None
    assert manager.maybe_save(2, params=model) is None
    assert manager.maybe_save(3, params=model).endswith("step_00000003")
    assert manager.restore_or_none(like_params=model)["step"] == 3


def test_data_pipeline_determinism_and_jax_bytes():
    a = SyntheticLM(1000, 32, 4, seed=9)
    b = SyntheticLM(1000, 32, 4, seed=9)
    for _ in range(3):
        np.testing.assert_array_equal(a.next_batch()["tokens"],
                                      b.next_batch()["tokens"])
    state = a.state_dict()
    x = a.next_batch()
    c = SyntheticLM(1000, 32, 4)
    c.load_state_dict(state)
    np.testing.assert_array_equal(c.next_batch()["tokens"], x["tokens"])
    # byte-identical to the JAX package's stream and its host shards
    for seed, vocab, seq, gb in ((0, 256, 16, 8), (7, 51865, 48, 6)):
        ours, theirs = SyntheticLM(vocab, seq, gb, seed=seed), \
            jdata.SyntheticLM(vocab, seq, gb, seed=seed)
        for _ in range(3):
            got, want = ours.next_batch(), theirs.next_batch()
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()
        for host in range(3):
            got = ShardedLoader(SyntheticLM(vocab, seq, gb, seed=seed),
                                host_id=host, num_hosts=3).next_batch()
            want = jdata.ShardedLoader(jdata.SyntheticLM(
                vocab, seq, gb, seed=seed), host_id=host,
                num_hosts=3).next_batch()
            for k in ("tokens", "labels"):
                assert got[k].tobytes() == want[k].tobytes()


def test_elastic_failure_resume_is_exact(tmp_path):
    """The twin of tests/test_system.py's: train 6 steps, checkpoint at 3,
    'lose a host', re-plan the mesh, restore, resume — the final
    parameters equal an uninterrupted run's bit for bit."""
    opt = AdamW(AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))

    def run_steps(model, state, data, n):
        step = make_train_step(model, opt)
        for _ in range(n):
            state, _ = step(state, data.next_batch())
        return state

    model = _tiny_model()
    data = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=3)
    state = run_steps(model, opt.init(model), data, 3)
    ckpt.save(str(tmp_path), 3, params=model, opt_state=state,
              data_state=data.state_dict())
    run_steps(model, state, data, 3)
    final_ref = model.state_dict()

    mon = fault.FleetMonitor(num_hosts=4, model_parallel=1)
    mon.mark_failed(1)
    plan = mon.remesh(devices_per_host=1)
    assert plan.size <= 3
    model2 = _tiny_model(seed=5)
    restored = ckpt.restore(str(tmp_path), like_params=model2,
                            like_opt=opt.init(model2))
    model2.load_state_dict(restored["params"])
    data2 = SyntheticLM(model.cfg.vocab_size, 16, 4)
    data2.load_state_dict(restored["data_state"])
    run_steps(model2, restored["opt_state"], data2, 3)
    for k, v in model2.state_dict().items():
        assert torch.equal(v, final_ref[k]), k


def test_train_launcher_wire_checkpoint_and_resume(tmp_path, capsys):
    """``launch.train --reduced --grad-wire int8`` with checkpoints, then a
    run cut after its first checkpoint (the later one removed) resumes
    from it, runs only the remaining steps and ends where the whole run
    ended — bit for bit without the wire; with it, the residuals restart
    at zero on a resume (they live with the run, not the checkpoint)."""
    base = ["--arch", "stablelm-1.6b", "--reduced", "--batch", "2",
            "--seq", "16", "--steps", "4", "--checkpoint-every", "2",
            "--log-every", "1", "--device", "cpu"]
    for wire, name in ((["--grad-wire", "int8"], "wire"), ([], "plain")):
        path = tmp_path / name
        args = base + wire + ["--checkpoint-dir", str(path)]
        whole = tlaunch.main(args)
        assert len(whole) == 4 and ckpt.latest_step(str(path)) == 4
        out = capsys.readouterr().out
        assert "device cpu" in out and "tok/s" in out
        assert ("wire_err" in out) == bool(wire)
        shutil.rmtree(path / "step_00000004")
        resumed = tlaunch.main(args)
        assert "resumed from step 2" in capsys.readouterr().out
        assert len(resumed) == 2 and all(np.isfinite(resumed))
        if not wire:
            assert resumed == whole[2:]


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b",
                                  "qwen3-moe-235b-a22b"])
def test_train_launcher_families(arch, capsys):
    losses = tlaunch.main(["--arch", arch, "--reduced", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--microbatches", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "parameters; 2 steps of 2×16" in capsys.readouterr().out


def test_kill_device_at_raises_on_the_one_card_mesh():
    """On one card the mesh is (data=1, model=1): losing its device leaves
    no survivor, and ``elastic_plan`` refuses, as it does for the JAX
    package's one-device mesh."""
    with pytest.raises(ValueError, match="cannot host"):
        tlaunch.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                      "3", "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--kill-device-at", "1"])


def test_example_twins_on_the_cpu(tmp_path, capsys):
    out = elastic_restart.main(["--device", "cpu", "--checkpoint-dir",
                                str(tmp_path / "e")])
    assert out["verdict"] == "EXACT RESUME"
    assert out["restored_bit_equal"] and out["sharded_loader_slices"]
    assert "EXACT RESUME" in capsys.readouterr().out
    losses = train_lm.main(["--steps", "3", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--checkpoint-dir",
                            str(tmp_path / "t")])
    assert len(losses) == 3
    toks = serve_lm.main(["--arch", "whisper-base", "--batch", "2",
                          "--prompt-len", "12", "--gen", "4", "--device",
                          "cpu"])
    assert tuple(toks.shape) == (2, 4)
