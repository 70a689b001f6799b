"""The port's model stack (``repro_torch.models``, ``train.serve``,
``launch.serve``) against the JAX package's ``repro.models``.

Each architecture of every family — dense (stablelm), ssm (mamba2),
hybrid (zamba2), vlm (pixtral), moe (qwen3-moe, llama4-scout) and encdec
(whisper) — at ``reduced()`` runs on the JAX package's parameters
(``Model.init`` from a fixed key, carried across by
``convert.model_params_from_jax``), on the same tokens (and patch
embeddings or frames) made with NumPy from a seed.  On the CPU the port's kernels
run their plain versions; JAX runs its jnp paths.

Tolerances, per output, against max |want| of that output:
* float32 (``cfg.replace(dtype="float32")``): |Δ| ≤ 1e-5·max(1, max |want|)
  — both compute in float32, in other summation orders;
* bfloat16 (the configs' compute dtype): |Δ| ≤ 2^-5·max |want| — JAX's
  fused CPU code keeps some bf16 intermediates in float32 and the port
  rounds each op, and the attention probabilities are bf16 in JAX and
  float32 in the port's kernel path, so the two differ by bf16 roundings
  carried through the layers (measured up to 0.9%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ref as jref
from repro.models.model import Model as JModel
from repro.train import serve as jserve
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.train import serve as tserve

ARCHS = ["stablelm-1.6b", "mamba2-1.3b", "zamba2-2.7b", "pixtral-12b",
         "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "whisper-base"]
DTYPES = ["float32", "bfloat16"]
B, S, PROMPT = 2, 16, 12
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -5

_cache: dict = {}


def _models(arch, dtype):
    """(JAX model, JAX params, port model, NumPy batch) for one case."""
    key = (arch, dtype)
    if key not in _cache:
        jcfg = jget_reduced(arch).replace(dtype=dtype)
        jm = JModel(jcfg)
        params, axes = jm.init(jax.random.PRNGKey(0))
        cfg = get_reduced(arch).replace(dtype=dtype)
        tm = Model(cfg, device="cpu")
        tm.load_state_dict(model_params_from_jax(
            jax.tree.map(np.asarray, params), axes, cfg))
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        batch.update(_extra(cfg, rng, B))
        _cache[key] = (jm, params, tm, batch)
    return _cache[key]


def _extra(cfg, rng, b):
    """The stub frontends' inputs: patch embeddings (vlm), frames
    (encdec)."""
    shape = {"vlm": ("patch_embeds", cfg.num_patches),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: (0.05 * rng.standard_normal(
        (b, shape[1], cfg.d_model))).astype(np.float32)}


def _jb(batch, **cut):
    return {k: jnp.asarray(v) for k, v in _cut(batch, **cut).items()}


def _tb(batch, **cut):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            _cut(batch, **cut).items()}


def _cut(batch, tokens=None, labels=True):
    out = dict(batch)
    if tokens is not None:
        out["tokens"] = batch["tokens"][:, :tokens]
    if not labels:
        out.pop("labels")
    return out


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    atol = (F32_TOL * max(1.0, scale) if dtype == "float32"
            else BF16_TOL * scale)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max |Δ| {err} > {atol}"


def _real_vocab(logits, cfg):
    return logits[..., :cfg.vocab_size]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_loss_match_jax(arch, dtype):
    jm, params, tm, batch = _models(arch, dtype)
    jl, jaux = jm.forward(params, _jb(batch))
    tl, taux = tm.forward(_tb(batch))
    assert tl.dtype == getattr(torch, dtype) and tl.shape == jl.shape
    _close(_real_vocab(tl, tm.cfg), _real_vocab(jl, tm.cfg), dtype,
           "logits")
    if tm.cfg.family == "moe":  # the load loss, summed over layers
        assert float(jaux) > 0
        tol = 1e-5 if dtype == "float32" else 2.0 ** -6
        assert abs(float(taux) - float(jaux)) <= tol * float(jaux)
    else:
        assert float(taux) == float(jaux) == 0.0
    jloss = float(jm.train_loss(params, _jb(batch)))
    tloss = float(tm.train_loss(_tb(batch)))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert abs(tloss - jloss) <= tol * abs(jloss), (tloss, jloss)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, dtype):
    """Prefill of the first PROMPT tokens (every cache leaf), then three
    teacher-forced decode steps (their logits and the caches after)."""
    jm, params, tm, batch = _models(arch, dtype)
    cfg = tm.cfg
    jl, jc = jm.prefill(params, _jb(batch, tokens=PROMPT, labels=False),
                        cache_len=S)
    tl, tc = tm.prefill(_tb(batch, tokens=PROMPT, labels=False),
                        cache_len=S)
    _close(_real_vocab(tl, cfg), _real_vocab(jl, cfg), dtype,
           "prefill logits")
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        _close(tc[k], jc[k], dtype, f"prefill cache {k}")
    for i in range(3):
        pos = PROMPT + i
        tok = batch["tokens"][:, pos:pos + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok), pos)
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok), pos)
        _close(_real_vocab(tl, cfg), _real_vocab(jl, cfg), dtype,
               f"decode {i} logits")
    for k in jc:
        _close(tc[k], jc[k], dtype, f"decoded cache {k}")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_decode_consistency(arch):
    """The port's twin of tests/test_models.py::test_arch_decode_consistency:
    prefill(t0..tn) + decode(t_n+1, t_n+2) logits match the teacher-forced
    forward pass, in float32 (atol = rtol = 2e-2, as there) and with
    no-drop MoE capacity, as there."""
    cfg = get_reduced(arch).replace(dtype="float32", capacity_factor=8.0)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, dtype=torch.int32)}
    batch.update({k: torch.from_numpy(v) for k, v in _extra(
        cfg, np.random.default_rng(2), b).items()})
    with torch.no_grad():
        full, _ = model.forward(batch)
        n_prompt = s - 2
        pre = dict(batch, tokens=batch["tokens"][:, :n_prompt])
        logits, cache = model.prefill(pre, cache_len=s)
        torch.testing.assert_close(logits[:, -1], full[:, n_prompt - 1],
                                   atol=2e-2, rtol=2e-2)
        for i in range(2):
            tok = batch["tokens"][:, n_prompt + i:n_prompt + i + 1]
            logits, cache = model.decode_step(cache, tok, n_prompt + i)
            torch.testing.assert_close(logits[:, -1], full[:, n_prompt + i],
                                       atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_full_config_parameter_count_on_meta(arch):
    """At the published config, built on ``device="meta"`` (nothing
    allocated): the port's parameter count is JAX's ``init_abstract``'s,
    and ``ModelConfig.num_params``."""
    model = Model(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    shapes, _ = JModel(jget_config(arch)).init_abstract()
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert model.num_params() == want == get_config(arch).num_params()
    if arch == "zamba2-2.7b":
        assert want == 2_422_386_848


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_abstract_trees_match_jax(arch):
    cfg = get_reduced(arch)
    shapes, axes = JModel(jget_reduced(arch)).init_abstract()
    model = Model(cfg, device="meta")
    assert model.axes() == axes
    got = jax.tree.map(lambda t: tuple(t.shape), model.abstract())
    assert got == jax.tree.map(lambda x: tuple(x.shape), shapes)
    _, cache_axes = model.init_cache(2, 8)
    _, jcache_axes = JModel(jget_reduced(arch)).init_cache(2, 8)
    assert cache_axes == jcache_axes


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b"])
@pytest.mark.parametrize("s", [192, 200])
def test_any_sequence_length_matches_jax(arch, s):
    """S not a multiple of 128 (the Pallas kernel's block): the port's
    model attends through the kernel wrapper, which takes any S, where it
    once inherited the block check.  forward, train_loss and prefill
    against JAX in float32 (1e-5·max(1, max |want|))."""
    jm, params, tm, _ = _models(arch, "float32")
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, tm.cfg.vocab_size, (1, s)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jl, _ = jm.forward(params, _jb(batch))
    with torch.no_grad():
        tl, _ = tm.forward(_tb(batch))
        tloss = float(tm.train_loss(_tb(batch)))
        tp, tc = tm.prefill(_tb(batch, labels=False), cache_len=s + 8)
    _close(_real_vocab(tl, tm.cfg), _real_vocab(jl, tm.cfg), "float32",
           "logits")
    jloss = float(jm.train_loss(params, _jb(batch)))
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
    jp, jc = jm.prefill(params, _jb(batch, labels=False), cache_len=s + 8)
    _close(_real_vocab(tp, tm.cfg), _real_vocab(jp, tm.cfg), "float32",
           "prefill logits")
    for k in jc:
        _close(tc[k], jc[k], "float32", f"prefill cache {k}")


def test_moe_capacity_drops_are_bounded():
    """The twin of tests/test_models.py::test_moe_capacity_drops_are_bounded:
    with capacity_factor ≥ 1 few assignments drop; the output stays finite
    and the load-balance loss is present.  The port also counts the drops
    (``moe_ffn(stats=...)``) and holds them against a NumPy recount of the
    same routing."""
    from repro_torch.models import moe as M

    cfg = get_reduced("qwen3-moe-235b-a22b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))}
    with torch.no_grad():
        logits, aux = model.forward(batch)
        assert bool(torch.isfinite(logits.float()).all())
        assert float(aux) > 0
        x = torch.from_numpy(rng.standard_normal(
            (4, 32, cfg.d_model)).astype(np.float32))
        stats = {}
        M.moe_ffn(model.layers[0]["moe"], x, cfg, stats=stats)
        _, ids, _ = M._route(model.layers[0]["moe"], x.reshape(-1, cfg.d_model),
                             cfg)
    cap = M.capacity_for(4 * 32, cfg)
    counts = np.bincount(ids.numpy().ravel(), minlength=cfg.num_experts)
    assert int(stats["dropped"]) == int(np.maximum(counts - cap, 0).sum())
    assert stats["assignments"] == ids.numel()
    assert int(stats["dropped"]) <= 0.25 * ids.numel()


@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 1, 8, 16),
                                   (2, 128, 4, 32, 2, 16, 32),
                                   (1, 512, 2, 64, 1, 64, 256)])
def test_ssd_scan_final_state_matches_jax(shape, impl):
    """``ops.ssd_scan(return_final_state=True)`` against JAX's
    ``ssd_scan_chunked_ref``: y and the (B, H, N, P) state after the last
    chunk within 2e-4 (tests/test_kernels.py's SSD tolerance)."""
    b, s, h, p, g, n, chunk = shape
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))
                ).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    jy, jst = jref.ssd_scan_chunked_ref(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                        chunk=chunk, return_final_state=True)
    ty, tst = tops.ssd_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                            chunk=chunk, impl=impl, return_final_state=True)
    assert tuple(tst.shape) == (b, h, n, p) and tst.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=2e-4)
    assert torch.equal(ty, tops.ssd_scan(*map(torch.from_numpy,
                                              (x, dt, a, bm, cm)),
                                         chunk=chunk, impl=impl))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b"])
def test_greedy_generation_matches_jax(arch):
    jm, params, tm, batch = _models(arch, "float32")
    prompt = batch["tokens"][:, :8]
    want = jserve.generate(jm, params, jnp.asarray(prompt), steps=6)
    got = tserve.generate(tm, torch.from_numpy(prompt), steps=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_reference_kernel_agrees_with_the_kernel_path(arch):
    """``kernel="reference"`` (the oracles) and ``kernel="cuda"`` (on the
    CPU the kernels' plain versions and ``ops.ssd_scan``'s cross-chunk
    loop) on the very same parameters: float32 logits within 1e-5·max."""
    _, _, tm, batch = _models(arch, "float32")
    ref = tm.with_kernel("reference")
    assert ref.kernel == "reference"
    assert ref.embed.table is tm.embed.table  # the same parameters
    b = _tb(batch, tokens=PROMPT, labels=False)
    with torch.no_grad():
        got, cache = tm.prefill(b, cache_len=S)
        want, ref_cache = ref.prefill(b, cache_len=S)
    _close(got, want.numpy(), "float32", "logits")
    for k in cache:
        _close(cache[k], ref_cache[k].numpy(), "float32", k)


def test_kernel_shapes_and_arguments_are_checked():
    cfg = get_reduced("zamba2-2.7b")
    with pytest.raises(ValueError, match="ssd_scan.cu"):
        Model(cfg.replace(ssm_head_dim=48), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        Model(cfg.replace(head_dim=12), device="meta")
    Model(cfg.replace(head_dim=12), kernel="reference", device="meta")
    with pytest.raises(ValueError, match="kernel"):
        Model(cfg, kernel="pallas", device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        if not torch.cuda.is_available():
            Model(cfg)  # the default device is the card
        else:
            raise RuntimeError("cuda is here")
    tm = _models("zamba2-2.7b", "float32")[2]
    with pytest.raises(ValueError, match="cache_len"):
        tm.prefill({"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                   cache_len=4)


def test_sampling_takes_an_explicit_generator():
    tm = _models("stablelm-1.6b", "float32")[2]
    step = tserve.make_decode_step(tm, greedy=False, temperature=0.7)
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    outs = []
    for _ in range(2):
        _, cache = tm.prefill({"tokens": prompt}, cache_len=8)
        with pytest.raises(ValueError, match="generator"):
            step(cache, prompt[:, -1:], 4)
        gen = torch.Generator().manual_seed(5)
        tok, cache, logits = step(cache, prompt[:, -1:], 4, generator=gen)
        assert tok.shape == (2, 1) and tok.dtype == torch.int32
        assert logits.shape == (2, tm.cfg.padded_vocab)
        outs.append(tok)
    assert torch.equal(outs[0], outs[1])


def test_bf16_weights_are_cast_once_and_renewed_on_change():
    """The model keeps one compute-dtype copy of each weight, made at the
    first prefill, shared with its ``with_kernel`` twins and dropped by
    ``init`` / ``load_state_dict``; the float32 SSM parameters stay the
    model's own.  Prefill through the copies is bit-equal to prefill
    through the float32 tree (cast at every use, as the JAX package
    does)."""
    from repro_torch.models import transformer as T

    cfg = get_reduced("zamba2-2.7b").replace(dtype="bfloat16")
    tm = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    assert tm.compute_bytes() == 0
    logits, cache = tm.prefill({"tokens": tokens}, cache_len=20)
    tree = tm.served()
    assert tm.served() is tree and tm.with_kernel("reference").served() is tree
    layer, own = tree.layers[0].ssm, tm.layers[0].ssm
    assert layer.in_proj.dtype == torch.bfloat16
    assert layer.a_log is own.a_log and layer.norm_scale is own.norm_scale
    weights = sum(p.numel() for n, p in tm.named_parameters() if not any(
        n.endswith(k) for k in ("a_log", "dt_bias", "d_skip", "norm_scale")))
    assert tm.compute_bytes() == 2 * weights
    want_logits, want_cache = T.prefill(tm, tokens, cfg, kernel="cuda",
                                        cache_len=20)
    assert torch.equal(logits, want_logits)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(want_cache)):
        assert torch.equal(a, b)
    tm.init(torch.Generator().manual_seed(5))
    assert tm.compute_bytes() == 0 and tm.served() is not tree
    tm.load_state_dict(tm.state_dict())
    assert tm.compute_bytes() == 0


def test_serve_launcher_on_the_cpu(capsys):
    out = tlaunch.main(["--arch", "zamba2-2.7b", "--reduced", "--batch", "2",
                        "--prompt-len", "16", "--gen", "4",
                        "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    text = capsys.readouterr().out
    assert "parameters; prefill 2×16" in text and "tok/s" in text
