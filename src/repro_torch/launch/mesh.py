"""Mesh construction on one card, as in the JAX package's
``launch/mesh.py``.  The port runs a model whole on one device, so the
host mesh is a (data=1, model=1) shape-only mesh: ``dist.sharding``'s rules
resolve against it and every spec replicates.  A ``torch.distributed``
``DeviceMesh`` across cards or ranks is ROADMAP Queue A item 13c's."""
from __future__ import annotations


class HostMesh:
    """Axis names and sizes, what ``dist.sharding`` reads of a mesh."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def make_host_mesh() -> HostMesh:
    """The one card as a (data, model) mesh of size 1."""
    return HostMesh(data=1, model=1)
