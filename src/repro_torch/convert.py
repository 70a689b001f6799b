"""Carries data across from the JAX package: the graph and a program's
initial state take the place a model's weights have in a model port.

Nothing here imports the JAX package; the arguments are its plain NumPy
arrays (a ``repro`` ``Graph``'s fields) or any object with an ``init``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph


def graph_from_arrays(src, dst, weights, num_vertices: int) -> Graph:
    """The port's :class:`Graph` from COO arrays (int32 src/dst, optional
    float32 weights), e.g. the fields of a JAX-package ``Graph``."""
    return Graph(
        num_vertices=int(num_vertices),
        src=np.ascontiguousarray(src, dtype=np.int32),
        dst=np.ascontiguousarray(dst, dtype=np.int32),
        weights=(None if weights is None
                 else np.ascontiguousarray(weights, dtype=np.float32)),
    )


def program_inputs(program, graph, *, device="cuda"):
    """``(state0, aux)`` of ``program.init(graph)`` as float32 tensors on
    ``device`` — the same initial state a JAX-package program starts from."""
    dev = resolve_device(device)
    state, aux = program.init(graph)
    return (torch.as_tensor(np.asarray(state, np.float32), device=dev),
            torch.as_tensor(np.asarray(aux, np.float32), device=dev))
