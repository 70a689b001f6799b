"""Train-step factory: loss and gradients, microbatch accumulation and the
AdamW update, as in the JAX package's ``train/step.py``.

The model holds its parameters, so a step takes the optimizer state and a
batch and returns the new state and the metrics; the parameters change in
place.  Gradients are ``torch.autograd.grad`` of ``model.train_loss``
(through the flash-attention and SSD kernels' ``autograd.Function``s on the
card), taken with the parameters asked to require grad for that call
only.  Choosing the microbatch count is the paper's Lemma-1 block-size
question at the training level: ``suggest_microbatches`` applies the same
closed form.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import pipeline as pl
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.kernels import accounting
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW

GRAD_WIRES = (None, "int8")


def init_wire_state(params) -> dict:
    """Zero error-feedback residuals, one float32 tensor per parameter —
    the carried state of ``grad_wire="int8"`` (see make_train_step)."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in items}


@contextlib.contextmanager
def _requiring_grad(params):
    """The parameters require grad inside the block, and not after."""
    for p in params:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in params:
            p.requires_grad_(False)


def as_batch(batch, device) -> dict:
    """A batch of arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(model: Model, batch, *, parts=None) -> tuple:
    """``(loss, grads)`` of ``model.train_loss`` on one batch; grads is a
    dict keyed by the model's parameter names (zeros for a parameter the
    loss does not read, as JAX gives).  ``parts`` receives the loss's
    cross-entropy and MoE terms."""
    names, params = zip(*model.named_parameters())
    with _requiring_grad(params):
        loss = model.train_loss(batch, parts=parts)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {
        k: (g if g is not None else torch.zeros_like(p))
        for k, p, g in zip(names, params, grads)}


def make_train_step(model: Model, optimizer: AdamW, *, microbatches: int = 1,
                    microbatch_shardings=None, grad_wire: str | None = None,
                    grad_wire_bits: int = 8):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.
    Batch leaves lead with the global batch dim.

    ``microbatches`` splits the batch into that many slices, accumulates
    their gradients in the parameter dtype (float32 zeros for float32
    parameters, bf16 for bf16 ones) and scales loss and gradients by
    ``1/microbatches``.

    On a grid of ranks (``model.mesh``, read at each call, so a
    ``Model.remesh`` takes effect) every rank is handed the same global
    batch and keeps its rows (``local_rows``: its shard of each
    microbatch over the batch axes, as the JAX package reshapes and then
    shards); the loss is normalised by the global token count, and when
    the rows are split each leaf's gradient is summed over the batch axes
    its spec does not claim (:func:`sum_partial_grads`: an FSDP leaf's
    came back reduce-scattered from its gather); the logged loss is the
    global one.  ``microbatch_shardings`` is accepted
    for the JAX signature and has no effect: ``dist.sharding.constrain``
    is the identity (a rank's activations lie whole on its device).

    ``grad_wire="int8"`` puts the gradient through the compressed-wire
    round of ``dist.collectives`` before the optimizer sees it: each tensor
    is quantized to ``grad_wire_bits``-bit integers with one per-tensor
    scale and the rounding error is fed back into the next step's tensor
    (EF-SGD).  The step then reads ``(opt_state, wire_state, batch) ->
    (opt_state, wire_state, metrics)`` with ``grad_wire_err`` (the norm of
    the delayed gradient mass) among the metrics; seed ``wire_state`` with
    :func:`init_wire_state`.
    """
    if grad_wire not in GRAD_WIRES:
        raise ValueError(f"grad_wire must be one of {GRAD_WIRES}, got "
                         f"{grad_wire!r}")
    del microbatch_shardings  # constrain is the identity
    device = model.embed.table.device

    def compute_grads(batch):
        """The loss and gradients of one global batch: each microbatch's
        accumulated and scaled by ``1/microbatches``.  On a grid, this
        rank's rows (its shard of each microbatch) and then, when the rows
        are split, the leaves' parts summed (:func:`sum_partial_grads`)
        and the global loss (the ranks' cross-entropy parts summed, the
        MoE term once)."""
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        rows = b // microbatches
        grid = shd.grid_of(model.mesh)
        scope = contextlib.nullcontext()
        if grid is not None:
            batch = {k: grid.local_rows(v, microbatches=microbatches)
                     for k, v in batch.items()}
            scope = shd.activation_sharding(grid, grid.rules, batch=rows)
        batch = as_batch(batch, device)
        per = next(iter(batch.values())).shape[0] // microbatches
        acc: dict = {}
        ce = torch.zeros((), dtype=torch.float32, device=device)
        aux = torch.zeros((), dtype=torch.float32, device=device)
        with scope:
            # a dry run's counter on meta samples this loop
            # (accounting.trips), as hlo_analysis multiplies the JAX
            # package's scan by its trips
            for i in accounting.trips(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                parts: dict = {}
                _, grads = loss_and_grads(model, mb, parts=parts)
                for k, g in grads.items():
                    if microbatches == 1:
                        acc[k] = g
                        continue
                    a = acc.get(k)
                    if a is None:  # the parameter dtype: f32, or bf16
                        a = torch.zeros(g.shape, device=g.device, dtype=(
                            g.dtype if g.dtype == torch.bfloat16
                            else torch.float32))
                    acc[k] = a + g.to(a.dtype)
                ce = ce + parts["ce"].to(torch.float32)
                aux = aux + parts["aux"].to(torch.float32)
        if microbatches > 1:
            inv = 1.0 / microbatches
            acc = {k: g * inv for k, g in acc.items()}
            ce, aux = ce * inv, aux * inv
        if grid is not None and grid.rows_split(rows):
            acc = sum_partial_grads(grid, acc, model.leaf_specs())
            ce = grid.all_reduce(ce, axis=grid.row_axis)
        return ce + aux, acc

    def train_step(opt_state, batch):
        loss, grads = compute_grads(batch)
        opt_state, metrics = optimizer.update(model, grads, opt_state)
        return opt_state, {"loss": loss, **metrics}

    if grad_wire is None:
        return train_step

    def wire_round(g, r):
        t = g.to(torch.float32) + r
        q, s = coll.quantize_int(t, grad_wire_bits)
        sent = coll.dequantize_int(q, s)
        return sent.to(g.dtype), t - sent

    def train_step_wire(opt_state, wire_state, batch):
        loss, grads = compute_grads(batch)
        sent, residuals = {}, {}
        for k in list(grads):  # each gradient freed once it is sent
            sent[k], residuals[k] = wire_round(grads.pop(k), wire_state[k])
        err = torch.sqrt(sum(torch.sum(r.to(torch.float32) ** 2)
                             for r in residuals.values()))
        opt_state, metrics = optimizer.update(model, sent, opt_state)
        return opt_state, residuals, {"loss": loss, "grad_wire_err": err,
                                      **metrics}

    return train_step_wire


def partial_axis(grid, spec):
    """The grid axis (``"data"``, ``"model"``, None: both, or ``"none"``)
    over which a leaf of ``spec`` holds a part of its gradient when the
    rows split: the batch axes its spec does not claim."""
    rows = set(shd._mesh_axes_for(grid.rules, shd.BATCH))
    for part in spec:
        if part is not None:
            rows -= set(part if isinstance(part, tuple) else (part,))
    if not rows:
        return "none"
    return shd.axis_key(grid, tuple(rows))


def sum_partial_grads(grid, grads: dict, specs: dict | None = None) -> dict:
    """``grads`` summed over the batch axes each leaf's spec does not claim
    (:func:`partial_axis`; every batch axis for a leaf ``specs`` does not
    name): one flattened buffer (one all_reduce) per axis and dtype, in
    the dict's order."""
    groups: dict = {}
    for k, g in grads.items():
        axis = partial_axis(grid, (specs or {}).get(k, ()))
        if axis != "none":
            groups.setdefault((axis, g.dtype), []).append(k)
    out = dict(grads)
    for (axis, _), keys in groups.items():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        grid.all_reduce(flat, axis=axis)
        at = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view(grads[k].shape)
            at += n
    return out


def suggest_microbatches(global_batch: int, *, bytes_per_sample: int,
                         hbm_budget: int, fixed_cost: float = 1e-3,
                         per_sample_cost: float = 1e-4) -> int:
    """Lemma-1-style microbatch choice: the largest microbatch whose
    activation working set fits the memory budget, rounded to a divisor of
    the global batch; the analytic model breaks ties toward fewer, larger
    blocks (lower fixed cost) as Eq. 2 does."""
    mb = max(1, hbm_budget // max(bytes_per_sample, 1))
    mb = min(mb, global_batch)
    while global_batch % mb:
        mb -= 1
    n = global_batch // mb
    best, _ = pl.optimal_integer_blocks(
        global_batch, per_sample_cost, per_sample_cost, per_sample_cost,
        fixed_cost)
    if best < mb and global_batch % best == 0:
        n = global_batch // best
    return n


def eval_step(model: Model):
    """``step(batch) -> loss``, without gradients."""
    device = model.embed.table.device

    @torch.no_grad()
    def step(batch):
        return model.train_loss(as_batch(batch, device))

    return step

