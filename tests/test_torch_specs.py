"""``repro_torch.launch.specs`` against the JAX package's
``launch/specs.py``: the meta-tensor stand-ins equal JAX's
``ShapeDtypeStruct``s leaf for leaf in shape, dtype and logical axes —
batches, decode caches, decode inputs and parameters (JAX's stacked layer
axis unstacked into ``convert.model_params_from_jax``'s names) — for every
architecture, and ``choose_microbatches`` gives JAX's count."""
import dataclasses

import numpy as np
import pytest

from repro.configs import ARCH_NAMES
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.launch import specs


def _cfgs(arch, full):
    return ((jget_config(arch), get_config(arch)) if full
            else (jget_reduced(arch), get_reduced(arch)))


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a dict tree, in key order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_same(jset, tset):
    """Leaf for leaf: shape, dtype and axes equal, trees keyed alike (JAX
    sorts a dict's keys)."""
    jl = dict(_flat(jset.args))
    tl = dict(_flat(tset.args))
    assert sorted(jl) == sorted(tl)
    for path in jl:
        assert tuple(tl[path].shape) == tuple(jl[path].shape), path
        assert _dtype(tl[path]) == np.dtype(jl[path].dtype).name, path
        assert tl[path].device.type == "meta", path
    ja = dict(_flat(jset.axes, ())) if isinstance(jset.axes, dict) else {
        (): jset.axes}
    ta = dict(_flat(tset.axes, ())) if isinstance(tset.axes, dict) else {
        (): tset.axes}
    assert ja == ta


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("full", [False, True])
def test_batch_and_decode_specs_equal_jax(arch, full):
    jcfg, tcfg = _cfgs(arch, full)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], global_batch=2,
                                    seq_len=64) if not full else \
            SHAPES[name]
        jshape = dataclasses.replace(JSHAPES[name],
                                     global_batch=shape.global_batch,
                                     seq_len=shape.seq_len)
        if shape.kind != "decode":
            for labels in (True, False):
                _assert_same(jspecs.batch_specs(jcfg, jshape,
                                                with_labels=labels),
                             specs.batch_specs(tcfg, shape,
                                               with_labels=labels))
        jin, tin = jspecs.input_specs(jcfg, jshape), specs.input_specs(
            tcfg, shape)
        assert sorted(jin) == sorted(tin)
        for key in jin:
            _assert_same(jin[key], tin[key])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch, True)
    _assert_same(jspecs.cache_specs(jcfg, 4, 1024),
                 specs.cache_specs(tcfg, 4, 1024))


def _unstacked(args, axes, cfg):
    """JAX's parameter specs under the port's state_dict names: a leaf
    whose axes start with "layers" split into one per layer."""
    depth = {"layers": cfg.num_layers, "decoder": cfg.num_layers,
             "encoder": cfg.num_encoder_layers}
    out = {}
    for path, leaf in _flat(args):
        ax = dict(_flat(axes))[path]
        if ax and ax[0] == "layers":
            assert leaf.shape[0] == depth[path[0]]
            for i in range(leaf.shape[0]):
                name = ".".join((path[0], str(i)) + path[1:])
                out[name] = (tuple(leaf.shape[1:]),
                             np.dtype(leaf.dtype).name, tuple(ax[1:]))
        else:
            out[".".join(path)] = (tuple(leaf.shape),
                                   np.dtype(leaf.dtype).name, tuple(ax))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("full", [False, True])
def test_params_specs_equal_jax_unstacked(arch, full):
    jcfg, tcfg = _cfgs(arch, full)
    jset = jspecs.params_specs(jcfg)
    tset = specs.params_specs(tcfg)
    want = _unstacked(jset.args, jset.axes, jcfg)
    got = {k: (tuple(p.shape), _dtype(p), tset.axes[k])
           for k, p in tset.args.items()}
    assert got == want
    assert all(p.device.type == "meta" for p in tset.args.values())
    assert set(tset.axes) == set(tset.args)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_choose_microbatches_equals_jax(arch):
    for full in (False, True):
        jcfg, tcfg = _cfgs(arch, full)
        for name in SHAPES:
            for b in (1, 8, 256, 512):
                shape = dataclasses.replace(SHAPES[name], global_batch=b)
                jshape = dataclasses.replace(JSHAPES[name], global_batch=b)
                for shards in (1, 16, 256):
                    assert specs.choose_microbatches(
                        tcfg, shape, data_shards=shards) == \
                        jspecs.choose_microbatches(jcfg, jshape,
                                                   data_shards=shards)


def test_specs_allocate_nothing():
    """The specs are meta tensors: a full-size cache of qwen2-72b (1.4 TB
    at decode_32k) is built without memory."""
    cfg = get_config("qwen2-72b")
    cache = specs.decode_specs(cfg, SHAPES["decode_32k"])["cache"]
    nbytes = sum(t.numel() * t.element_size() for t in cache.args.values())
    assert nbytes > 1e12
    assert all(t.device.type == "meta" for t in cache.args.values())
