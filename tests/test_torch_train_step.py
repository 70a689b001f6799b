"""One training step of the port (``repro_torch.train.step.make_train_step``)
against the JAX package's, per architecture at ``reduced()`` in float32
(the other half of the architectures is in
``tests/test_torch_train_step_more.py``).

Both start from the JAX package's parameters (``convert.model_params_from_
jax``) and take the same batch, made with NumPy from a seed.  Checked:

* the loss within 1e-5 of JAX's, relative;
* every gradient leaf within 1e-4 · max |want| of that leaf (float32 sums
  in other orders through every layer; measured up to 3.3e-5, the SSM
  leaves the largest);
* the updated parameters and m, v within 1e-6 (absolute; the parameters
  are O(1)) of JAX's ``apply_updates`` fed the port's own gradients.  The
  step is held to JAX's optimizer on equal gradients, and the gradients to
  JAX's on equal parameters: Adam's first step moves a parameter by about
  lr·g/(|g| + eps), so where a clipped gradient is as small as eps a
  last-bit difference in it moves the parameter by up to 2·lr, and the
  two steps cannot be compared end to end more tightly than that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models.model import Model as JModel
from repro.models.layers import bf16_cotangent as jbf16_cotangent
from repro.dist import collectives as jcoll
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import apply_updates as japply_updates
from repro_torch.configs import get_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.step import (init_wire_state, loss_and_grads,
                                    make_train_step)

B, S = 2, 16
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
ARCHS = [("stablelm-1.6b", {}), ("stablelm-1.6b", {"bf16_cotangent": True}),
         ("phi4-mini-3.8b", {}), ("command-r-35b", {}), ("qwen2-72b", {}),
         ("pixtral-12b", {})]


def setup(arch, **over):
    """(JAX model, JAX params, axes, port model, NumPy batch)."""
    jcfg = jget_reduced(arch).replace(dtype="float32", **over)
    jm = JModel(jcfg)
    params, axes = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(arch).replace(dtype="float32", **over)
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(model_params_from_jax(
        jax.tree.map(np.asarray, params), axes, cfg))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    extra = {"vlm": ("patch_embeds", cfg.num_patches),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra:
        batch[extra[0]] = (0.05 * rng.standard_normal(
            (B, extra[1], cfg.d_model))).astype(np.float32)
    return jm, params, axes, tm, batch


def to_jax_tree(flat, like, axes):
    """A port dict (``state_dict`` names) as the JAX tree of ``like``:
    the inverse of ``convert.model_params_from_jax``."""
    def walk(p, a, path):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k], path + (k,)) for k in p}
        if a and a[0] == "layers":
            return jnp.stack([jnp.asarray(flat[".".join(
                (path[0], str(i)) + path[1:])].numpy())
                for i in range(p.shape[0])])
        return jnp.asarray(flat[".".join(path)].numpy())
    return walk(like, axes, ())


def close_leaves(got: dict, want: dict, rtol: float, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].detach().float()
        scale = float(w.abs().max())
        err = float((g - w.float()).abs().max())
        assert err <= rtol * scale + 1e-30, f"{what} {k}: {err} > " \
            f"{rtol} · {scale}"


def check_arch(arch, over):
    jm, params, axes, tm, batch = setup(arch, **over)
    cfg = tm.cfg
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jm.train_loss)(params, jbatch)
    loss, grads = loss_and_grads(tm, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    close_leaves(grads, model_params_from_jax(
        jax.tree.map(np.asarray, jgrads), axes, cfg), GRAD_TOL, "grad")

    # the step: the port's gradients through JAX's optimizer
    want_p, want_s, want_m = japply_updates(
        params, to_jax_tree(grads, params, axes),
        {"m": jax.tree.map(jnp.zeros_like, params),
         "v": jax.tree.map(jnp.zeros_like, params),
         "step": jnp.zeros((), jnp.int32)}, JAdamWConfig(**OPT))
    opt = AdamW(AdamWConfig(**OPT))
    state, metrics = make_train_step(tm, opt)(opt.init(tm), batch)
    assert float(metrics["loss"]) == float(loss)
    assert abs(float(metrics["grad_norm"]) - float(want_m["grad_norm"])) \
        <= 1e-6 * float(want_m["grad_norm"])
    assert float(metrics["lr"]) == float(want_m["lr"])
    assert int(state["step"]) == int(want_s["step"]) == 1
    for name, got, want in (
            ("param", tm.state_dict(), want_p),
            ("m", state["m"], want_s["m"]), ("v", state["v"], want_s["v"])):
        want = model_params_from_jax(jax.tree.map(np.asarray, want), axes,
                                     cfg)
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= PARAM_ATOL, f"{arch} {name} {k}: {err}"


@pytest.mark.parametrize("arch, over", ARCHS,
                         ids=[a + ("-bf16cot" if o else "") for a, o in ARCHS])
def test_train_step_matches_jax(arch, over):
    check_arch(arch, over)


def test_bf16_cotangent_backward_matches_jax():
    """``maybe_bf16_cotangent``: the identity forward, the cotangent rounded
    through bf16 — bit-equal to JAX's ``custom_vjp``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    g = (rng.standard_normal((3, 5, 7)) * 1e3).astype(np.float32)
    out, vjp = jax.vjp(jbf16_cotangent, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = L.maybe_bf16_cotangent(xt, True)
    assert torch.equal(y.detach(), xt.detach())
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]))
    assert L.maybe_bf16_cotangent(xt, False) is xt


def test_grad_wire_int8_step_matches_jax():
    """``grad_wire="int8"``: the residuals bit-equal to JAX's quantize /
    dequantize round of the port's gradients, ``grad_wire_err`` their norm
    (rel 1e-6), the parameters within 1e-6 of JAX's optimizer on the sent
    gradients; a second step carries the residuals."""
    jm, params, axes, tm, batch = setup("stablelm-1.6b")
    cfg = tm.cfg
    _, grads = loss_and_grads(tm, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    sent, resid = {}, {}
    for k, g in grads.items():
        t = jnp.asarray(g.numpy())
        q, s = jcoll.quantize_int(t, 8)
        sent[k] = torch.from_numpy(np.array(jcoll.dequantize_int(q, s)))
        resid[k] = np.asarray(t - jcoll.dequantize_int(q, s))
    want_p, _, _ = japply_updates(
        params, to_jax_tree(sent, params, axes),
        {"m": jax.tree.map(jnp.zeros_like, params),
         "v": jax.tree.map(jnp.zeros_like, params),
         "step": jnp.zeros((), jnp.int32)}, JAdamWConfig(**OPT))
    opt = AdamW(AdamWConfig(**OPT))
    step = make_train_step(tm, opt, grad_wire="int8")
    wire = init_wire_state(tm)
    state, wire, metrics = step(opt.init(tm), wire, batch)
    for k, r in resid.items():
        np.testing.assert_array_equal(wire[k].numpy(), r, err_msg=k)
    err = np.sqrt(sum(float((r.astype(np.float64) ** 2).sum())
                      for r in resid.values()))
    assert abs(float(metrics["grad_wire_err"]) - err) <= 1e-6 * err
    want = model_params_from_jax(jax.tree.map(np.asarray, want_p), axes, cfg)
    for k, w in want.items():
        assert float((tm.state_dict()[k] - w).abs().max()) <= PARAM_ATOL, k
    state, wire2, metrics = step(state, wire, batch)
    assert int(state["step"]) == 2 and np.isfinite(float(metrics["loss"]))
    assert set(wire2) == set(wire)
    with pytest.raises(ValueError, match="grad_wire"):
        make_train_step(tm, opt, grad_wire="int4")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-235b-a22b",
                                  "whisper-base", "stablelm-1.6b"])
def test_remat_on_and_off_give_equal_grads(arch):
    """Rematerialization (per layer; per group in the hybrid family)
    recomputes the same forward: the gradients are bit-equal to those of
    the model without it."""
    cfg = get_reduced(arch).replace(dtype="float32")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy((0.05 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32))
    got = {}
    for remat in (True, False):
        tm = Model(cfg.replace(remat=remat), device="cpu").init(
            torch.Generator().manual_seed(0))
        got[remat] = loss_and_grads(tm, batch)
    assert torch.equal(got[True][0], got[False][0])
    for k, g in got[True][1].items():
        assert torch.equal(g, got[False][1][k]), k
