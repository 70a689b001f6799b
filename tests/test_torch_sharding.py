"""The port's logical-axis sharding rules (``repro_torch.dist.sharding``)
against the JAX package's ``repro.dist.sharding``.

``make_rules``, ``spec_for`` and ``tree_specs`` read only a mesh's
``axis_names`` and ``shape``, so the production meshes of
tests/test_dist_properties.py run as shape-only meshes: every strategy's
rule table must equal JAX's, every spec must equal JAX's ``PartitionSpec``
as a tuple (200 seeded random shapes per mesh and strategy), and a model's
spec tree equal JAX's ``spec_for`` over JAX's abstract parameters and
axes.  ``placements_for`` is checked on shape-only meshes and on a
one-process ``DeviceMesh`` (gloo), where ``distribute_tensor`` takes its
placements.  On one card ``constrain`` returns the very same tensor, in a
context or not.
"""
import itertools
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.dist import sharding as jshd
from repro.models.model import Model as JModel
from repro_torch.configs import get_reduced
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model


class ShapeOnlyMesh:
    """Axis names + sizes, nothing else — enough for rule/spec logic."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = [
    ShapeOnlyMesh(data=4, model=2),
    ShapeOnlyMesh(data=16, model=16),
    ShapeOnlyMesh(pod=2, data=16, model=16),
    ShapeOnlyMesh(data=1, model=1),
]
MESH_IDS = ["x".join(f"{k}{v}" for k, v in m.shape.items()) for m in MESHES]


def test_logical_axis_names_match_jax():
    assert shd.LOGICAL_AXES == jshd.LOGICAL_AXES
    assert shd.STRATEGIES == jshd.STRATEGIES


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_rules_match_jax(mesh, strategy):
    assert shd.make_rules(mesh, strategy=strategy) == jshd.make_rules(
        mesh, strategy=strategy)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_spec_for_matches_jax_with_fallback_and_uniqueness(mesh, strategy):
    rules = shd.make_rules(mesh, strategy=strategy)
    rng = np.random.default_rng(0)
    logical = (None,) + shd.LOGICAL_AXES + ("layers",)
    for _ in range(200):
        ndim = int(rng.integers(1, 5))
        axes = tuple(logical[i] for i in rng.integers(0, len(logical), ndim))
        shape = tuple(int(rng.integers(1, 70)) for _ in range(ndim))
        spec = shd.spec_for(shape, axes, mesh, rules)
        assert spec == tuple(jshd.spec_for(shape, axes, mesh, rules))
        used = []
        for dim, part in itertools.zip_longest(shape, spec):
            if part is None:
                continue
            names = part if isinstance(part, tuple) else (part,)
            assert dim % int(np.prod([mesh.shape[a] for a in names])) == 0
            used.extend(names)
        assert len(used) == len(set(used)), (shape, axes, spec)


@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_spec_non_divisible_always_replicates(strategy):
    mesh = ShapeOnlyMesh(data=4, model=2)
    rules = shd.make_rules(mesh, strategy=strategy)
    for ax in shd.LOGICAL_AXES:
        assert shd.spec_for((7,), (ax,), mesh, rules) == ()


def test_spec_cases_of_tests_test_sharding():
    """tests/test_sharding.py's cases on a (data=1, model=n) mesh, n = 4:
    divisible, the fallback, no mesh axis twice, a pre-resolved tuple."""
    mesh = ShapeOnlyMesh(data=1, model=4)
    rules = shd.make_rules(mesh)
    assert shd.spec_for((16, 8), (shd.TENSOR, None), mesh, rules) == (
        "model",)
    assert shd.spec_for((5, 8), (shd.TENSOR, None), mesh, rules) == ()
    assert shd.spec_for((16, 16), (shd.TENSOR, shd.VOCAB), mesh,
                        rules) == ("model",)
    assert shd.spec_for((16,), (("data", "model"),), mesh, rules) == (
        ("data", "model"),)
    assert shd.spec_for((3, 4), None, mesh, rules) == ()
    with pytest.raises(ValueError, match="do not match"):
        shd.spec_for((3, 4), (None,), mesh, rules)


def test_rules_reject_unknown_strategy():
    with pytest.raises(ValueError):
        shd.make_rules(ShapeOnlyMesh(data=2), strategy="3d")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b",
                                  "zamba2-2.7b", "pixtral-12b"])
@pytest.mark.parametrize("strategy", shd.STRATEGIES)
def test_model_tree_specs_match_jax(arch, strategy):
    """``tree_specs`` over the port model's abstract tree and axes equals
    JAX's ``spec_for`` mapped over its ``init_abstract`` (the counterpart
    of ``tree_shardings``), on a (data=2, model=4) mesh."""
    mesh = ShapeOnlyMesh(data=2, model=4)
    rules = shd.make_rules(mesh, strategy=strategy)
    model = Model(get_reduced(arch), device="meta")
    got = shd.tree_specs(model.abstract(), model.axes(), mesh, rules)
    shapes, axes = JModel(jget_reduced(arch)).init_abstract()
    want = jax.tree.map(
        lambda leaf, ax: tuple(jshd.spec_for(leaf.shape, ax, mesh, rules)),
        shapes, axes)
    assert got == want


def test_tree_specs_walks_lists_and_refuses_mismatches():
    mesh = ShapeOnlyMesh(data=2, model=2)
    rules = shd.make_rules(mesh)
    tree = {"w": [torch.empty(4, 6), torch.empty(3)]}
    axes = {"w": [(shd.FSDP, shd.TENSOR), (shd.TENSOR,)]}
    assert shd.tree_specs(tree, axes, mesh, rules) == {
        "w": [("data", "model"), ()]}
    with pytest.raises(ValueError):
        shd.tree_specs({"w": torch.empty(2)}, {"v": (None,)}, mesh, rules)


def test_placements_for_shape_only_meshes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = ShapeOnlyMesh(data=2, model=4)
    assert shd.placements_for((), mesh) == (Replicate(), Replicate())
    assert shd.placements_for(("model",), mesh) == (Replicate(), Shard(0))
    assert shd.placements_for((None, "data", "model"), mesh) == (
        Shard(1), Shard(2))
    assert shd.placements_for((("data", "model"),), mesh) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError, match="twice"):
        shd.placements_for(("model", "model"), mesh)
    with pytest.raises(ValueError, match="not in"):
        shd.placements_for(("pod",), mesh)
    # every spec of a model maps to one placement per mesh axis
    rules = shd.make_rules(mesh)
    model = Model(get_reduced("zamba2-2.7b"), device="meta")
    specs = shd.tree_specs(model.abstract(), model.axes(), mesh, rules)

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t

    for spec in leaves(specs):
        assert len(shd.placements_for(spec, mesh)) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_placements_for_a_device_mesh():
    """A one-process (data=1, model=1) ``DeviceMesh`` over gloo: its axis
    names and sizes drive the rules, and ``distribute_tensor`` takes the
    placements."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = shd.make_rules(mesh, strategy="serve")
        assert rules == shd.make_rules(ShapeOnlyMesh(data=1, model=1),
                                       strategy="serve")
        w = torch.arange(24.0).reshape(4, 6)
        spec = shd.spec_for(w.shape, (shd.FSDP, shd.TENSOR), mesh, rules)
        assert spec == (None, "model")
        dt = distribute_tensor(w, mesh, shd.placements_for(spec, mesh))
        assert torch.equal(dt.full_tensor(), w)
    finally:
        dist.destroy_process_group()


def test_constrain_is_the_identity_with_or_without_a_context():
    x = torch.ones(4, 4)
    assert shd.constrain(x, (shd.BATCH, None)) is x
    assert shd.active_context() is None
    mesh = make_host_mesh()
    rules = shd.make_rules(mesh)
    with shd.activation_sharding(mesh, rules):
        assert shd.active_context() == (mesh, rules)
        assert shd.constrain(x, (None, shd.TENSOR)) is x
        inner = ShapeOnlyMesh(data=2)
        with shd.activation_sharding(inner, {}):
            assert shd.active_context() == (inner, {})
        assert shd.active_context() == (mesh, rules)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            shd.active_context()))
        t.start()
        t.join()
        assert seen == [None]  # the context is thread-local
    assert shd.active_context() is None
    assert jshd.constrain(x, (shd.BATCH, None)) is x  # JAX's, outside one
