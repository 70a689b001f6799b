"""The dry run's dot FLOPs against the JAX package's: every architecture's
train step at its reduced config (B=2, S=128), traced on the meta device
through ``kernel="cuda"`` (the card's path, launches planned) and through
``kernel="reference"``, against ``repro.launch.hlo_analysis.analyze`` of
the JAX step jitted on one CPU device (the JAX package's own small-mesh
dry run fails on the reference side, ROADMAP Queue C, so it is no oracle).

Within 1%: the reference path, and the kernel path less
``kernel_recompute_dot_flops`` — the plain forward each kernel Function's
backward recomputes before it differentiates it (one attention or SSD
forward a layer a step; ROADMAP Queue C), which JAX's backward does not
do.  That excess is pinned exactly: half the planned launches' dots (each
layer launches twice under remat, and its backward recomputes once).  The
prefill and decode cells are in ``test_torch_dryrun_serve.py``.
"""
import dataclasses

import jax
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_reduced as jget_reduced
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro.models.model import Model as JModel
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.serve import make_decode_step as jmake_decode_step
from repro.train.serve import make_prefill_step as jmake_prefill_step
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter

B, S = 2, 128
FLOPS_RTOL = 0.01
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}


def jax_dot_flops(arch: str, kind: str) -> float:
    """``hlo_analysis.analyze(...).dot_flops`` of the JAX step of a reduced
    cell, jitted on one CPU device."""
    cfg = jget_reduced(arch)
    shape = dataclasses.replace(JSHAPES[SHAPE_OF[kind]], seq_len=S,
                                global_batch=B)
    model = JModel(cfg)
    params = jspecs.params_specs(cfg).args
    if kind == "train":
        opt = JAdamW(JAdamWConfig())
        fn = jax.jit(jmake_train_step(model, opt))
        args = (params, jax.eval_shape(opt.init, params),
                jspecs.batch_specs(cfg, shape, with_labels=True).args)
    elif kind == "prefill":
        fn = jax.jit(jmake_prefill_step(model, cache_len=S))
        args = (params,
                jspecs.batch_specs(cfg, shape, with_labels=False).args)
    else:
        dec = jspecs.decode_specs(cfg, shape)
        step = jmake_decode_step(model)
        fn = jax.jit(lambda p, c, t, pos: step(p, c, t, pos)[:2])
        args = (params, dec["cache"].args, dec["token"].args,
                dec["pos"].args)
    hlo = fn.lower(*args).compile().as_text()
    return hlo_analysis.analyze(hlo, world=1).dot_flops


def port_stats(arch: str, kind: str, kernel: str):
    """OpStats of the port's step of the same cell, traced on meta."""
    step = dryrun.build_step(arch, SHAPE_OF[kind], reduced=True, batch=B,
                             seq=S, kernel=kernel)
    with OpCounter() as c:
        out = step.run()
    del out
    return c.stats()


def check_cell(arch: str, kind: str) -> None:
    want = jax_dot_flops(arch, kind)
    cuda = port_stats(arch, kind, "cuda")
    ref = port_stats(arch, kind, "reference")
    assert abs(ref.dot_flops / want - 1) <= FLOPS_RTOL, (ref.dot_flops, want)
    own = cuda.dot_flops - cuda.kernel_recompute_dot_flops
    assert abs(own / want - 1) <= FLOPS_RTOL, (own, want)
    cfg = get_reduced(arch)
    if kind == "train":
        assert cuda.kernel_recompute_dot_flops == cuda.kernel_dot_flops / 2
        if cfg.family not in ("ssm", "hybrid"):
            # attention: the kernel path's own dots are the reference's
            assert own == ref.dot_flops
    else:
        assert cuda.kernel_recompute_dot_flops == 0
        assert cuda.dot_flops == ref.dot_flops


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_dot_flops_within_one_percent_of_jax(arch):
    check_cell(arch, "train")
