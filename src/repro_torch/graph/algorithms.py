"""Graph algorithms as GX-Plug vertex programs, in PyTorch (the JAX
package's ``graph/algorithms.py``: PageRank, multi-source Bellman-Ford
SSSP, Label Propagation, WCC and BFS levels).

Each program supplies the three template APIs plus initialization, and
names its message function in ``core.template.GEN_OPS`` for the CUDA
kernels.  ``init`` returns the same NumPy arrays as the JAX package's, so
the two packages start every run from identical state.  The batched
multi-source programs of the serving layer (``repro_torch.serve``) stack B
queries into the state columns: :data:`BATCHED_QUERIES`.
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


# --------------------------------------------------------------------------
# Batched multi-source query variants (repro_torch.serve).
#
# Each program stacks B independent queries into the state columns, so ONE
# step answers a whole batch.  All declare the BatchQueryCapable contract
# (num_queries + query_activity): the shared apply step freezes each
# query's columns the round they go quiet, so a finished query stops
# feeding the shared frontier while its batch-mates keep running.
#
# Equivalence contract (tests/test_torch_serve.py):
#   * min-monoid programs (batched_khop, batched_sssp): column b of the
#     batched run is BIT-IDENTICAL to a single-query run of query b —
#     extra messages generated by batch-mates' frontiers re-send a
#     source's unchanged state and are no-ops under min, and a quiet
#     column is its fixed point, so freeze-by-revert == commit.
#   * sum-monoid batched_ppr: columns evolve independently (messages for
#     column b read only column b), so answers agree across batch
#     compositions and lie within ``tol`` of an unmasked run (the freeze
#     reverts one sub-tolerance apply).  Its message function divides
#     every column by the out-degree, as the kernels' ``pr_div_deg`` does.
# --------------------------------------------------------------------------
def _seed_lists(seeds, n: int) -> list[list[int]]:
    """Normalizes query seeds: an int per query or an iterable per query
    (multi-seed queries), vertex ids wrapped into range."""
    out = []
    for q in seeds:
        ids = [q] if np.isscalar(q) else list(q)
        if not ids:
            raise ValueError("each query needs at least one seed vertex")
        out.append([int(s) % n for s in ids])
    return out


def _min_query_activity(old, new):
    return new < old  # (N, B): min-monoid state only ever decreases


def _seeded_inf_init(lists):
    b = len(lists)

    def init(g: Graph):
        n = g.num_vertices
        state = np.full((n, b), INF, dtype=np.float32)
        for q, ids in enumerate(lists):
            state[ids, q] = 0.0
        return state, np.zeros((n, 0), dtype=np.float32)

    return init


def batched_khop(graph: Graph, seeds, hops: int = 3,
                 max_iterations: int | None = None) -> VertexProgram:
    """B k-hop neighborhood queries as one program.

    State column b holds the hop distance from query b's seed(s), INF
    beyond ``hops`` — the budget clamp rejects any message that would land
    past the horizon, so the frontier never grows beyond the k-hop ball
    and the run converges in ≤ hops+1 iterations.  Membership =
    ``state <= hops``; the distance itself is the useful answer.
    """
    lists = _seed_lists(seeds, graph.num_vertices)
    b = len(lists)

    def msg_apply(state, merged, has_msg, aux, t):
        cand = torch.minimum(state, merged)
        new = torch.where(cand <= float(hops), cand, state)
        active = torch.any(new < state, dim=-1)
        return new, active

    return VertexProgram(
        name="batched_khop",
        state_width=b,
        aux_width=0,
        monoid=MIN,
        msg_gen=_bfs_msg_gen,
        msg_apply=msg_apply,
        init=_seeded_inf_init(lists),
        max_iterations=max_iterations or hops + 2,
        frontier_driven=True,
        gen_op="add_one",
        num_queries=b,
        query_activity=_min_query_activity,
    )


def batched_sssp(graph: Graph, seeds,
                 max_iterations: int = 10_000) -> VertexProgram:
    """B shortest-path queries (single- or multi-seed each) as one
    program: column b is the Bellman-Ford distance to the NEAREST of query
    b's seeds (a multi-seed query initializes all its seeds at 0, which
    under min is exactly the distance-to-set)."""
    lists = _seed_lists(seeds, graph.num_vertices)
    return VertexProgram(
        name="batched_sssp",
        state_width=len(lists),
        aux_width=0,
        monoid=MIN,
        msg_gen=_sssp_msg_gen,
        msg_apply=_sssp_msg_apply,
        init=_seeded_inf_init(lists),
        max_iterations=max_iterations,
        frontier_driven=True,
        gen_op="add_weight",
        num_queries=len(lists),
        query_activity=_min_query_activity,
    )


def _ppr_msg_gen(src_state, dst_state, weight, src_aux):
    # every query column over the out-degree (aux column 0): the kernels'
    # pr_div_deg divides all K columns, unlike pagerank's column 0 alone
    deg = torch.clamp(src_aux[:, :1], min=1.0)
    return src_state / deg


def batched_ppr(graph: Graph, seeds, *, alpha: float = 0.85,
                tol: float = 1e-6,
                max_iterations: int = 50) -> VertexProgram:
    """B personalized-PageRank queries as one program.

    Column b runs the power iteration ``r' = (1-α)·e_b + α·P·r`` where
    ``e_b`` is query b's restart distribution (uniform over its seed set),
    carried in aux so a serving family can swap seed sets per batch
    (``Middleware.run(init=...)``).  Sum monoid: not bit-exact against an
    unmasked run (the per-query freeze reverts one sub-``tol`` apply).
    """
    lists = _seed_lists(seeds, graph.num_vertices)
    b = len(lists)

    def init(g: Graph):
        n = g.num_vertices
        restart = np.zeros((n, b), dtype=np.float32)
        for q, ids in enumerate(lists):
            uniq = np.unique(np.asarray(ids, dtype=np.int64))
            restart[uniq, q] = 1.0 / uniq.size
        aux = np.concatenate(
            [graph.out_degrees().reshape(n, 1), restart], axis=1)
        return restart.copy(), aux

    def msg_apply(state, merged, has_msg, aux, t):
        restart = aux[:, 1:]
        new = (1.0 - alpha) * restart + alpha * merged
        active = torch.amax(torch.abs(new - state), dim=-1) > tol
        return new, active

    def query_activity(old, new):
        return torch.abs(new - old) > tol

    return VertexProgram(
        name="batched_ppr",
        state_width=b,
        aux_width=1 + b,
        monoid=SUM,
        msg_gen=_ppr_msg_gen,
        msg_apply=msg_apply,
        init=init,
        max_iterations=max_iterations,
        frontier_driven=False,
        gen_op="pr_div_deg",
        num_queries=b,
        query_activity=query_activity,
    )


ALGORITHMS = {
    "pagerank": pagerank,
    "sssp_bf": sssp_bf,
    "label_prop": label_prop,
    "wcc": wcc,
    "bfs": bfs,
}

#: Batched multi-source query factories (repro_torch.serve).  Signature:
#: ``factory(graph, seeds, **params) -> VertexProgram`` where ``seeds`` is
#: one entry per query (an int or an iterable of ints).
BATCHED_QUERIES = {
    "khop": batched_khop,
    "sssp": batched_sssp,
    "ppr": batched_ppr,
}
