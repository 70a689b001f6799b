"""The dry run's traces on the meta device, without the JAX package: the
card's path (``kernel="cuda"``) traces for every architecture and kind
with its launches planned (never made: the library is neither built nor
called), as many as the layers ask; the meta trace's peak equals the same
step's on CPU tensors; the kernel path holds no S×S scores in a prefill;
a record round-trips through ``launch/reanalyze.py``; the CLI writes its
records where it says and refuses a mesh across cards; the MoE's
assignment count traces on meta and equals ``bincount``'s."""
import json

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import moe

B, S = 2, 128


def _trace(arch, shape, *, kernel="cuda", device="meta", seq=S):
    step = dryrun.build_step(arch, shape, reduced=True, batch=B, seq=seq,
                             kernel=kernel, device=device)
    with OpCounter(device=device) as c:
        out = step.run()
    del out
    return c.stats()


def _layer_launches(cfg) -> dict:
    """Kernel launches of one forward pass: attention per attention layer
    (the hybrid's shared block once a group, the encoder's and decoder's
    layers), the SSD per Mamba2 layer."""
    attn = {"hybrid": cfg.num_layers // cfg.attn_every, "ssm": 0,
            "encdec": cfg.num_layers + cfg.num_encoder_layers}.get(
        cfg.family, cfg.num_layers)
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {k: v for k, v in (("flash_attention", attn),
                              ("ssd_chunk", mamba)) if v}


@pytest.fixture
def no_library(monkeypatch):
    """The CUDA library may not be built or called, and the wrappers'
    counts of real launches stay as they are."""
    def refuse():
        raise AssertionError("a meta trace reached the CUDA library")

    monkeypatch.setattr(build, "library", refuse)
    before = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    yield
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == before


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_the_cards_path_traces_on_meta_with_planned_launches(arch,
                                                             no_library):
    """Train, prefill and decode through ``kernel="cuda"`` on meta: one
    launch a layer in a prefill, two in a train step (the remat
    recompute), none in decode; every count finite and positive."""
    cfg = get_reduced(arch)
    per_pass = _layer_launches(cfg)
    train = _trace(arch, "train_4k")
    prefill = _trace(arch, "prefill_32k")
    decode = _trace(arch, "decode_32k")
    assert train.kernel_launches == {k: 2 * v for k, v in per_pass.items()}
    assert prefill.kernel_launches == per_pass
    assert decode.kernel_launches == {}
    for st in (train, prefill, decode):
        assert st.dot_flops > 0 and st.peak_bytes > 0
        assert st.collective_bytes == 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b",
                                  "qwen3-moe-235b-a22b", "whisper-base",
                                  "pixtral-12b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_peak_equals_the_cpu_peak(arch, shape):
    """The same step (``kernel="reference"``, whose ops are the same on
    both devices) counts the same live bytes on meta tensors as on CPU
    tensors, and the same dots."""
    meta = _trace(arch, shape, kernel="reference")
    cpu = _trace(arch, shape, kernel="reference", device="cpu")
    assert meta.peak_bytes == cpu.peak_bytes > 0
    assert meta.end_bytes == cpu.end_bytes
    assert meta.dot_flops == cpu.dot_flops


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if get_reduced(a).family != "ssm"])
def test_the_kernel_prefill_holds_no_scores(arch):
    """At S=512 a prefill through the attention kernel peaks below the
    reference's, which materializes each layer's (S, S) scores.  (Pure
    SSM stacks are the other way round: ``ops.ssd_scan`` holds every
    chunk's state at once, where the reference loops over chunks.)"""
    cuda = _trace(arch, "prefill_32k", seq=512)
    ref = _trace(arch, "prefill_32k", kernel="reference", seq=512)
    assert cuda.peak_bytes < ref.peak_bytes
    assert cuda.dot_flops == ref.dot_flops
    # nor does it move them: a launch is charged its own inputs and outputs
    assert cuda.dot_bytes < ref.dot_bytes
    assert cuda.bytes_accessed < ref.bytes_accessed


def test_run_cell_writes_a_record_and_a_trace(tmp_path, no_library):
    rec = dryrun.run_cell("zamba2-2.7b", "train_4k", reduced=True, batch=4,
                          seq=64, microbatches=4, out_dir=str(tmp_path))
    stem = "zamba2-2.7b__train_4k__h100x1__reduced"
    assert json.loads((tmp_path / f"{stem}.json").read_text()) == rec
    assert (tmp_path / f"{stem}.ops.json.gz").exists()
    assert rec["mesh"] == "h100x1" and rec["world"] == 1
    assert rec["microbatches"] == 4
    assert rec["ops"]["kernel_launches"] == {"flash_attention": 16,
                                             "ssd_chunk": 32}
    assert rec["ops"]["loop_trips"] == [4]
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                          + mem["temp_bytes"])
    assert mem["argument_bytes"] > 3 * 4 * rec["num_params"]  # p, m, v
    if not torch.cuda.is_available():
        assert rec["fits"] is None and rec["device"]["name"] is None
    r = rec["roofline"]
    assert r["peak_flops"] == dryrun.PEAK_FLOPS["bfloat16"]
    assert r["compute_s"] == rec["ops"]["dot_flops_per_device"] / 989e12
    o = rec["ops"]
    assert o["bytes_accessed_per_device"] > o["dot_bytes_per_device"]
    assert r["memory_s"] == max(
        o["bytes_accessed_per_device"], o["dot_bytes_per_device"],
        mem["argument_bytes"] + mem["output_bytes"]) / dryrun.HBM_BW
    assert r["dominant"] in ("compute", "memory")


def test_reanalyze_restores_a_perturbed_record(tmp_path):
    rec = dryrun.run_cell("stablelm-1.6b", "prefill_32k", reduced=True,
                          batch=2, seq=64, out_dir=str(tmp_path))
    path = tmp_path / "stablelm-1.6b__prefill_32k__h100x1__reduced.json"
    bad = json.loads(path.read_text())
    bad["ops"]["dot_flops_per_device"] = 1.0
    bad["ops"]["kernel_launches"] = {}
    bad["memory"]["temp_bytes"] = 0
    bad["roofline"] = {}
    path.write_text(json.dumps(bad))
    assert reanalyze.reanalyze_dir(str(tmp_path)) == 1
    assert json.loads(path.read_text()) == rec


def test_cli_runs_a_reduced_cell_and_refuses_a_mesh_across_cards(tmp_path,
                                                                  capsys):
    """The CLI writes one reduced cell's record on one card, and — where it
    once refused a mesh across cards — one for rank 0 of each grid:
    ``--multi-pod`` (2x16x16, 512 ranks), ``--single-pod`` (16x16, 256)
    and ``--strategy fsdp|serve`` (16x16), each with its world, mesh tag
    and strategy in the record and the stem."""
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                 "--reduced", "--seq", "64", "--out-dir", str(tmp_path)])
    assert "1 of 1 cells" in capsys.readouterr().out
    assert (tmp_path / "mamba2-1.3b__decode_32k__h100x1__reduced.json"
            ).exists()
    for argv, stem, world, strategy in (
            (["--multi-pod"], "h100_2x16x16", 512, "2d"),
            (["--single-pod"], "h100_16x16", 256, "2d"),
            (["--strategy", "fsdp"], "h100_16x16__fsdp", 256, "fsdp"),
            (["--strategy", "serve"], "h100_16x16__serve", 256, "serve")):
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                     "--reduced", "--out-dir", str(tmp_path), *argv])
        assert "1 of 1 cells" in capsys.readouterr().out
        rec = json.loads((tmp_path / f"mamba2-1.3b__train_4k__{stem}"
                          "__reduced.json").read_text())
        assert (rec["world"], rec["strategy"]) == (world, strategy)
        assert rec["mesh"] == stem.split("__")[0]
        assert set(rec["ops"]["collective_by_axis"]) <= {"data", "model",
                                                         "grid"}


def test_moe_assignment_count_equals_bincount_and_traces_on_meta():
    """The router's per-expert assignment count (an index_add of ones in
    place of ``torch.bincount``, which has no meta kernel) gives the same
    aux loss bit for bit, and the MoE layer traces on meta."""
    cfg = get_reduced("qwen3-moe-235b-a22b")
    gen = torch.Generator().manual_seed(0)
    xf = torch.randn((64, cfg.d_model), generator=gen)
    p = {"router": torch.randn((cfg.d_model, cfg.num_experts),
                               generator=gen)}
    gates, ids, aux = moe._route(p, xf, cfg)
    e, k, t = cfg.num_experts, cfg.experts_per_token, xf.shape[0]
    probs = torch.softmax(xf @ p["router"], dim=-1)
    ce = torch.bincount(ids.reshape(-1), minlength=e).to(torch.float32) / (
        t * k)
    assert torch.equal(aux, e * torch.sum(probs.mean(dim=0) * ce))
    meta = {"router": p["router"].to("meta")}
    with OpCounter() as c:
        _, _, aux_m = moe._route(meta, xf.to("meta"), cfg)
    assert aux_m.shape == () and c.stats().dot_flops > 0
