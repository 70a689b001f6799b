"""Graph algorithms as GX-Plug vertex programs, in PyTorch (the JAX
package's ``graph/algorithms.py``: PageRank, multi-source Bellman-Ford
SSSP, Label Propagation, WCC and BFS levels).

Each program supplies the three template APIs plus initialization, and
names its message function in ``core.template.GEN_OPS`` for the CUDA
kernels.  ``init`` returns the same NumPy arrays as the JAX package's, so
the two packages start every run from identical state.  The batched
serving programs come with the serving slice (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.template import MIN, SUM, VertexProgram
from repro_torch.graph.structure import Graph

INF = float(np.finfo(np.float32).max)


# --------------------------------------------------------------------------
# PageRank (sum monoid). State: rank (K=1). Aux: out_degree.
# --------------------------------------------------------------------------
def _pr_msg_gen(src_state, dst_state, weight, src_aux):
    deg = torch.clamp(src_aux[:, :1], min=1.0)
    return src_state[:, :1] / deg


def _pr_msg_apply(state, merged, has_msg, aux, t, *, damping, n, tol):
    new = (1.0 - damping) / n + damping * merged
    active = torch.abs(new - state)[:, 0] > tol
    return new, active


def _pr_init(graph: Graph):
    n = graph.num_vertices
    state = np.full((n, 1), 1.0 / n, dtype=np.float32)
    aux = graph.out_degrees().reshape(n, 1)
    return state, aux


def pagerank(graph: Graph, *, damping: float = 0.85, tol: float = 1e-8,
             max_iterations: int = 30) -> VertexProgram:
    return VertexProgram(
        name="pagerank",
        state_width=1,
        aux_width=1,
        monoid=SUM,
        msg_gen=_pr_msg_gen,
        msg_apply=functools.partial(
            _pr_msg_apply, damping=damping, n=graph.num_vertices, tol=tol
        ),
        init=_pr_init,
        max_iterations=max_iterations,
        # PR generates messages from every vertex each round (power iteration):
        frontier_driven=False,
        gen_op="pr_div_deg",
    )


# --------------------------------------------------------------------------
# Multi-source Bellman-Ford SSSP (min monoid), state width K = #sources.
# --------------------------------------------------------------------------
def _sssp_msg_gen(src_state, dst_state, weight, src_aux):
    return src_state + weight  # broadcast (E,K) + (E,1)


def _sssp_msg_apply(state, merged, has_msg, aux, t):
    new = torch.minimum(state, merged)
    active = torch.any(new < state, dim=-1)
    return new, active


def sssp_bf(graph: Graph, sources: list[int] | None = None,
            max_iterations: int = 10_000) -> VertexProgram:
    if sources is None:
        sources = [0, 1, 2, 3]
    sources = [s % graph.num_vertices for s in sources]

    def init(g: Graph):
        n = g.num_vertices
        state = np.full((n, len(sources)), INF, dtype=np.float32)
        for k, s in enumerate(sources):
            state[s, k] = 0.0
        aux = np.zeros((n, 0), dtype=np.float32)
        return state, aux

    return VertexProgram(
        name="sssp_bf",
        state_width=len(sources),
        aux_width=0,
        monoid=MIN,
        msg_gen=_sssp_msg_gen,
        msg_apply=_sssp_msg_apply,
        init=init,
        max_iterations=max_iterations,
        frontier_driven=True,
        gen_op="add_weight",
    )


# --------------------------------------------------------------------------
# Label Propagation (sum monoid over class distributions); seed vertices
# are clamped to their one-hot label.
# --------------------------------------------------------------------------
def _lp_msg_gen(src_state, dst_state, weight, src_aux):
    return src_state * weight


def _lp_msg_apply(state, merged, has_msg, aux, t):
    total = torch.sum(merged, dim=-1, keepdim=True)
    normed = torch.where(total > 0, merged / torch.clamp(total, min=1e-12),
                         state)
    seed = aux[:, :1] >= 0.0
    seed_label = torch.clamp(aux[:, 0], min=0.0).to(torch.int64)
    rows = torch.arange(state.shape[0], device=state.device)
    onehot = torch.zeros_like(state).index_put_(
        (rows, seed_label), torch.ones((), dtype=state.dtype,
                                       device=state.device))
    new = torch.where(seed, onehot, normed)
    active = torch.amax(torch.abs(new - state), dim=-1) > 1e-6
    return new, active


def label_prop(graph: Graph, *, num_classes: int = 8, seed_fraction: float = 0.05,
               rng_seed: int = 0, max_iterations: int = 15) -> VertexProgram:
    def init(g: Graph):
        n = g.num_vertices
        rng = np.random.default_rng(rng_seed)
        labels = np.full((n,), -1.0, dtype=np.float32)
        n_seed = max(num_classes, int(seed_fraction * n))
        seeds = rng.choice(n, size=min(n_seed, n), replace=False)
        labels[seeds] = rng.integers(0, num_classes, size=seeds.shape[0])
        state = np.full((n, num_classes), 1.0 / num_classes, dtype=np.float32)
        hot = labels >= 0
        state[hot] = 0.0
        state[hot, labels[hot].astype(np.int64)] = 1.0
        return state, labels.reshape(n, 1)

    return VertexProgram(
        name="label_prop",
        state_width=num_classes,
        aux_width=1,
        monoid=SUM,
        msg_gen=_lp_msg_gen,
        msg_apply=_lp_msg_apply,
        init=init,
        max_iterations=max_iterations,
        frontier_driven=False,
        gen_op="mul_weight",
    )


# --------------------------------------------------------------------------
# Weakly Connected Components (min monoid over component ids). Run on the
# symmetrized graph (graph.with_reverse_edges()).
# --------------------------------------------------------------------------
def _wcc_msg_gen(src_state, dst_state, weight, src_aux):
    return src_state


def _wcc_msg_apply(state, merged, has_msg, aux, t):
    new = torch.minimum(state, merged)
    active = (new < state)[:, 0]
    return new, active


def wcc(graph: Graph, max_iterations: int = 10_000) -> VertexProgram:
    def init(g: Graph):
        n = g.num_vertices
        state = np.arange(n, dtype=np.float32).reshape(n, 1)
        return state, np.zeros((n, 0), dtype=np.float32)

    return VertexProgram(
        name="wcc",
        state_width=1,
        aux_width=0,
        monoid=MIN,
        msg_gen=_wcc_msg_gen,
        msg_apply=_wcc_msg_apply,
        init=init,
        max_iterations=max_iterations,
        frontier_driven=True,
        gen_op="copy_src",
    )


# --------------------------------------------------------------------------
# BFS levels (min monoid). msg = level + 1.
# --------------------------------------------------------------------------
def _bfs_msg_gen(src_state, dst_state, weight, src_aux):
    return src_state + 1.0


def bfs(graph: Graph, source: int = 0, max_iterations: int = 10_000) -> VertexProgram:
    def init(g: Graph):
        n = g.num_vertices
        state = np.full((n, 1), INF, dtype=np.float32)
        state[source % n, 0] = 0.0
        return state, np.zeros((n, 0), dtype=np.float32)

    return VertexProgram(
        name="bfs",
        state_width=1,
        aux_width=0,
        monoid=MIN,
        msg_gen=_bfs_msg_gen,
        msg_apply=_sssp_msg_apply,
        init=init,
        max_iterations=max_iterations,
        frontier_driven=True,
        gen_op="add_one",
    )


ALGORITHMS = {
    "pagerank": pagerank,
    "sssp_bf": sssp_bf,
    "label_prop": label_prop,
    "wcc": wcc,
    "bfs": bfs,
}
