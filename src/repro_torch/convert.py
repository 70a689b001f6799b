"""Carries data across from the JAX package: the graph and a program's
initial state, and a model's parameter tree.

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


def model_params_from_jax(params, axes, cfg, *, mesh=None) -> dict:
    """A JAX-package model's parameters as the port's ``state_dict``.

    ``params`` is the JAX parameter tree with NumPy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``) and ``axes`` its logical-axes
    tree from the same ``init`` — or any tree of that structure, such as
    the gradients of the parameters.  A leaf whose axes start with
    ``"layers"`` is stacked for the JAX package's scan: it is unstacked
    into ``<stack>.<i>.<path>`` (the stacks: ``layers``, and the
    encoder-decoder's ``encoder`` and ``decoder``).  The port keeps every
    weight at the JAX shape (the einsum weights ``wq`` (d, H, hd), ``wo``
    (H, hd, d), the experts' (E, d, f), …), so nothing else is reshaped;
    leaves keep their dtype (``cfg.param_dtype`` in both packages).

    With ``mesh`` a ``dist.sharding.RankGrid``, each leaf is the rank's
    block of it (``RankGrid.param_spec`` of the leaf's own axes — those
    after ``"layers"`` for a stacked one — cut by ``local_slice``): the
    state dict of ``Model(cfg, mesh=grid)`` on that rank."""
    depth = {"layers": cfg.num_layers, "decoder": cfg.num_layers,
             "encoder": cfg.num_encoder_layers}
    out: dict = {}

    def walk(p, a, path):
        if isinstance(p, dict):
            if set(p) != set(a):
                raise ValueError(f"axes at {'.'.join(path) or 'the root'} "
                                 f"do not match the parameters")
            for k in p:
                walk(p[k], a[k], path + (k,))
            return
        arr = np.asarray(p)
        if len(a) != arr.ndim:
            raise ValueError(f"{'.'.join(path)}: axes {a} for shape "
                             f"{arr.shape}")
        if a and a[0] == "layers":
            if arr.shape[0] != depth.get(path[0]):
                raise ValueError(f"{'.'.join(path)}: a stacked leaf outside "
                                 f"the stacks {depth}")
            for i in range(arr.shape[0]):
                key = ".".join((path[0], str(i)) + path[1:])
                out[key] = local(arr[i], a[1:])
        else:
            out[".".join(path)] = local(arr, a)

    def local(arr, a):
        if mesh is not None:
            spec = mesh.param_spec(arr.shape, a)
            if spec:
                arr = arr[mesh.local_slice(arr.shape, spec)]
        return torch.from_numpy(np.array(arr))

    walk(params, axes, ())
    return out
