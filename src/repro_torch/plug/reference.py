"""Dense PyTorch full-graph reference: the oracle the port's backends are
held against (the JAX package's ``plug/reference.py``).  No blocks, no
shards, no middleware — one Gen → Merge → Apply per iteration over the
whole edge list, on ``device``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.template import VertexProgram, segment_sum
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph


def run_reference(graph: Graph, program: VertexProgram,
                  max_iterations: int | None = None, *,
                  device="cuda") -> tuple[np.ndarray, int]:
    dev = resolve_device(device)
    state, aux = program.init(graph)
    state = torch.as_tensor(state, device=dev)
    aux = torch.as_tensor(aux, device=dev)
    src = torch.as_tensor(graph.src, device=dev).long()
    dst = torch.as_tensor(graph.dst, device=dev).long()
    w = torch.as_tensor(graph.weights if graph.weights is not None
                        else np.ones(graph.num_edges, np.float32),
                        device=dev)[:, None]
    max_it = max_iterations or program.max_iterations
    n = graph.num_vertices
    monoid = program.monoid
    cnt = segment_sum(torch.ones_like(dst), dst, n)
    has = (cnt > 0)[:, None]

    it = 0
    for it in range(1, max_it + 1):
        msgs = program.msg_gen(state[src], state[dst], w, aux[src])
        agg = monoid.segment_reduce(msgs, dst, n)
        agg = torch.where(has, agg, torch.full_like(agg, monoid.identity))
        state, active = program.msg_apply(state, agg, has, aux, it)
        if not bool(active.any()):
            break
    return state.cpu().numpy(), it
