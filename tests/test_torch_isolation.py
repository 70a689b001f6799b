"""The port stands alone: it never imports JAX or the JAX package, it never
carries on on the CPU when CUDA was asked for, and its kernel wrappers take
their plain versions only for CPU tensors."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import plug
from repro_torch.graph import algorithms, generate
from repro_torch.kernels import edge_block as ebk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_every_port_module_leaves_jax_out():
    """In a fresh interpreter: import the package and every submodule,
    then ``jax`` and ``repro`` must be absent from ``sys.modules``."""
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)"
    r"|import_module\(\s*['\"](jax|repro)\b", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                        ROOT / "chip_smoke.py",
                                        ROOT / "tests" / "torch_ranks_worker.py"]))
def test_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path


_LAUNCH_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+repro_torch\.launch\b"
    r"|^\s*from\s+repro_torch\s+import\s+[^\n]*\blaunch\b", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for layer in ("kernels", "models", "train", "dist", "plug")
    for p in (PORT / layer).rglob("*.py")))
def test_lower_layers_import_no_launcher(path):
    """The kernels, the models, the train step, the distributed layer and
    the middleware know nothing of the command-line layer: a dry run's
    counter reaches the first three only through ``kernels/accounting.py``,
    and a ``RankMesh`` lives in ``dist``, not in ``launch``."""
    assert not _LAUNCH_IMPORT.findall((ROOT / path).read_text()), path


def test_spawned_rank_entries_leave_jax_out():
    """In a fresh interpreter, as a spawned rank starts: the rank entries
    of the tests and the spawn helper import nothing of JAX or the JAX
    package."""
    code = (
        "import sys\n"
        "import torch_ranks_worker\n"
        "from repro_torch.launch import mesh\n"
        "assert callable(mesh.spawn_ranks)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _graph():
    return generate.rmat(64, 400, seed=3)


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    g = _graph()
    prog = algorithms.sssp_bf(g)
    with pytest.raises(RuntimeError, match="cuda"):
        plug.Middleware(g, prog)               # the default device
    with pytest.raises(RuntimeError, match="cuda"):
        plug.Middleware(g, prog, daemon=plug.VectorizedDaemon(
            kernel="cuda", csr_config=ops.CSRConfig()), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        plug.run_reference(g, prog)
    # the engine shim and the graph examples' twins default to the card too
    from repro_torch.core.engine import GXEngine
    from repro_torch.examples import graph_analytics, quickstart
    with pytest.raises(RuntimeError, match="cuda"):
        GXEngine(g, prog)
    for example in (quickstart, graph_analytics):
        with pytest.raises(RuntimeError, match="cuda"):
            example.main(["--num-vertices", "64", "--num-edges", "400"])


def test_wrappers_take_the_plain_path_on_cpu_tensors_only():
    g = _graph()
    prog = algorithms.sssp_bf(g, sources=[0, 1])
    rng = np.random.default_rng(0)
    nb, vb, b = 2, 16, 32
    arrs = [torch.from_numpy(a) for a in (
        rng.uniform(0, 5, (nb, vb, 2)).astype(np.float32),
        np.zeros((nb, vb, 1), np.float32),
        rng.integers(0, vb, (nb, b)).astype(np.int32),
        rng.integers(0, vb, (nb, b)).astype(np.int32),
        rng.uniform(1, 2, (nb, b, 1)).astype(np.float32),
        np.ones((nb, b), np.float32))]
    launches = (ebk.edge_block.launches, ebk.csr_tile.launches)
    got = ebk.edge_block(*arrs, program=prog)
    want = ebk.edge_block_plain(*arrs, program=prog)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    targs = [arrs[0], arrs[1], arrs[0], arrs[2], torch.sort(arrs[3])[0],
             arrs[4], arrs[5]]
    got = ebk.csr_tile(*targs, program=prog)
    want = ebk.csr_tile_plain(*targs, program=prog)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (ebk.edge_block.launches, ebk.csr_tile.launches) == launches


def test_wrappers_check_dtype_shape_and_contiguity():
    prog = algorithms.wcc(_graph())
    good = [torch.zeros(2, 8, 1), torch.zeros(2, 8, 1),
            torch.zeros(2, 4, dtype=torch.int32),
            torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, 4, 1),
            torch.ones(2, 4)]
    ebk.edge_block(*good, program=prog)
    bad_dtype = list(good)
    bad_dtype[2] = bad_dtype[2].long()
    with pytest.raises(TypeError, match="lsrc"):
        ebk.edge_block(*bad_dtype, program=prog)
    bad_shape = list(good)
    bad_shape[4] = torch.ones(2, 4)
    with pytest.raises(ValueError, match="w"):
        ebk.edge_block(*bad_shape, program=prog)
    strided = list(good)
    strided[0] = torch.zeros(2, 8, 2)[:, :, :1]
    with pytest.raises(ValueError, match="contiguous"):
        ebk.edge_block(*strided, program=prog)
    mixed = list(good)
    mixed[1] = torch.zeros(2, 8, 1, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ebk.edge_block(*mixed, program=prog)


def test_csr_aggregate_off_the_cpu_launches_the_kernel_or_raises():
    """Off the CPU, csr_aggregate runs the CSR-tile kernel: on a device
    the kernel does not run on it raises instead of taking a plain path."""
    prog = algorithms.sssp_bf(_graph(), sources=[0])
    t, et, rt, st, n = 2, 8, 4, 8, 64
    meta = dict(device="meta")
    csr = {"svids": torch.zeros(t, st, dtype=torch.int32, **meta),
           "rows": torch.zeros(t, rt, dtype=torch.int32, **meta),
           "lsrc": torch.zeros(t, et, dtype=torch.int32, **meta),
           "seg": torch.zeros(t, et, dtype=torch.int32, **meta),
           "w": torch.zeros(t, et, 1, **meta),
           "emask": torch.zeros(t, et, dtype=torch.bool, **meta)}
    launches = ebk.csr_tile.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.csr_aggregate(torch.zeros(n, 1, **meta), torch.zeros(n, 0, **meta),
                          csr, program=prog, num_vertices=n,
                          config=ops.CSRConfig())
    assert ebk.csr_tile.launches == launches


def _attn_args():
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))]


def _ssd_args():
    rng = np.random.default_rng(2)
    b, nc, l, h, p, g, n = 1, 2, 8, 2, 4, 1, 3
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, nc, l, h, p)),
        rng.uniform(0.1, 1.0, (b, nc, l, h)), -rng.uniform(0.5, 1.5, h),
        rng.standard_normal((b, nc, l, g, n)),
        rng.standard_normal((b, nc, l, g, n)))]


def test_model_kernel_wrappers_take_the_plain_path_on_cpu_tensors_only():
    launches = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    q, k, v = _attn_args()
    for causal in (True, False):
        assert torch.equal(fa.flash_attention(q, k, v, causal=causal),
                           fa.flash_attention_plain(q, k, v, causal=causal))
    args = _ssd_args()
    got, want = ssd.ssd_chunk(*args), ssd.ssd_chunk_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == launches


def test_model_kernel_wrappers_check_dtype_device_and_contiguity():
    q, k, v = _attn_args()
    with pytest.raises(TypeError, match="k: dtype"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="v: dtype"):
        fa.flash_attention(q, k, v.to(torch.bfloat16))
    with pytest.raises(TypeError, match="q: dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(q, k.to("meta"), v)
    # meta tensors (a dry run) take the card's branch with a planned launch:
    # an output of q's shape, no library, no count
    launches = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    out = fa.flash_attention(*(t.to("meta") for t in (q, k, v)))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(*(t[..., :12].contiguous().to("meta")
                             for t in (q, k, v)))
    args = _ssd_args()
    for i, name in enumerate(("x", "dt", "a", "b_mat", "c_mat")):
        mixed = list(args)
        mixed[i] = mixed[i].double()
        with pytest.raises(TypeError, match=name):
            ssd.ssd_chunk(*mixed)
    strided = list(args)
    strided[0] = args[0].transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_chunk(*strided)
    with pytest.raises(ValueError, match="head dims"):  # P=4
        ssd.ssd_chunk(*(t.to("meta") for t in args))
    p16 = [torch.zeros((*args[0].shape[:4], 16)), *args[1:]]
    outs = ssd.ssd_chunk(*(t.to("meta") for t in p16))
    assert [tuple(t.shape) for t in outs] == [
        tuple(t.shape) for t in ssd.ssd_chunk_plain(*p16)]
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == launches


@pytest.mark.parametrize("kwargs", [
    {"lowering": "xla"}, {"merge": "segment"}, {"gather": "dense"},
    {"lowering": "pallas"}])
def test_csr_config_rejects_unknown_or_kernel_less_choices(kwargs):
    """The port's lowerings are ``cuda`` (the kernel) and ``torch`` (its
    plain twin): the JAX package's names and unknown merges or gathers are
    refused."""
    with pytest.raises(ValueError):
        ops.CSRConfig(**kwargs)


@pytest.mark.parametrize("kwargs, item", [
    ({"upper": plug.MeshUpperSystem(mesh=("shard", 2))}, 13),
    ({"upper": plug.MeshUpperSystem(wire="compressed")}, 13),
    ({"model": "async", "daemon": "sharded", "upper": "mesh"}, 8),
    ({"upper": plug.MeshUpperSystem(mesh=object())}, 13),
    ({"model": "async"}, 8),
    ({"monitor": object()}, 9),
    ({"failures": object()}, 9),
    ({"mutations": object()}, 10),
    ({"oocore": object()}, 11),
])
def test_later_slices_raise_not_implemented(kwargs, item):
    """A composition of a later slice raises naming its ROADMAP item.  One
    whose item is ported runs: item 8, the async model, is the fused async
    loop with the sharded daemon and the mesh upper and the host loop
    otherwise, to run_reference's fixed point; items 9, 10 and 11
    (``monitor=``, ``failures=``, ``mutations=``, ``oocore=``) are options
    of the fused loops, which this composition (``daemon="reference"``,
    ``upper="host"``) refuses with a ``ValueError`` naming it, as the JAX
    package does — out of core never falls back to a resident run.  Item
    13b's compressed wire runs for a sum and refuses a min program."""
    g = _graph()
    prog = algorithms.bfs(g)
    if item == 8:
        mw = plug.Middleware(g, prog, device="cpu", **kwargs)
        fused = kwargs.get("daemon") == "sharded"
        assert mw._fused_kind == ("async" if fused else None)
        assert isinstance(mw._loop, plug.AsyncDriveLoop if fused
                          else plug.HostDriveLoop)
        res = mw.run()
        assert res.converged
        ref, _ = plug.run_reference(g, prog, device="cpu")
        np.testing.assert_array_equal(res.state, ref)
        return
    if item in (9, 10, 11):
        with pytest.raises(ValueError, match="fused"):
            plug.Middleware(g, prog, device="cpu", **kwargs)
        return
    if getattr(kwargs.get("upper"), "wire", "exact") == "compressed":
        # item 13b's compressed wire is ported: a min program is refused
        # with the JAX package's ValueError, a sum runs the host loop
        with pytest.raises(ValueError, match="idempotent"):
            plug.Middleware(g, prog, device="cpu", **kwargs)
        mw = plug.Middleware(g, algorithms.pagerank(g), device="cpu",
                             upper=plug.MeshUpperSystem(wire="compressed"))
        assert mw._fused_kind is None and mw.run(max_iterations=3).iterations
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        plug.Middleware(g, prog, device="cpu", **kwargs)


@pytest.mark.parametrize("method, item", [
    ("migrate", 9), ("rebalance", 9), ("apply_mutations", 10),
    ("run_dynamic", 10)])
def test_later_slice_methods_raise_not_implemented(method, item):
    """Items 9 and 10 are ported: on a host-loop middleware without a
    monitor, ``migrate`` and an unobserved ``rebalance`` refuse with a
    ``ValueError`` as the JAX package's do; an empty batch publishes no
    epoch, and ``run_dynamic`` of it restarts cold to run_reference's fixed
    point.  Item 11 is ported too: no ``NotImplementedError`` is left, and
    the out-of-core re-plan refuses a composition that is not out of core
    with a ``ValueError``, as the JAX package's does."""
    g = _graph()
    prog = algorithms.bfs(g)
    mw = plug.Middleware(g, prog, device="cpu")
    if method in ("migrate", "rebalance"):
        with pytest.raises(ValueError, match="monitor|busy times"):
            getattr(mw, method)()
    elif method == "apply_mutations":
        assert mw.apply_mutations(plug.MutationLog()) is mw.epochs.epoch
        assert mw.epochs.version == 0
    else:
        res = mw.run_dynamic(plug.MutationLog())
        assert mw.last_restart["mode"] == "cold"
        ref, _ = plug.run_reference(g, prog, device="cpu")
        np.testing.assert_array_equal(res.state, ref)
    with pytest.raises(ValueError, match="out-of-core"):
        mw.oocore_replan()
