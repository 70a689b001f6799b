"""AdamW with a warmup-cosine schedule, as in the JAX package's
``train/optimizer.py`` — its arithmetic in its order, in float32: the clip
scale from the pre-clip global norm, bias correction by ``b**step``, decay
only on parameters of two or more dims, and ``state_dtype`` for m and v.
It is not ``torch.optim.AdamW``, whose schedule, clip and decay rule
differ.

The port's model holds its parameters, so an update writes them (and m
and v) in place under ``torch.no_grad()`` and returns the state and the
metrics.  Trees are flat dicts keyed by the model's ``state_dict`` names.
The JAX package stacks a model's layers on a leading axis, so a layer's
norm scale is 2-D there and decays; the port counts that axis
(``Model.stacked_names``) so that the same parameters decay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # bfloat16 halves m/v memory


def named(params) -> dict:
    """``params`` as a dict name → tensor (a module's named parameters)."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a float32 0-d tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, decay)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    params = named(params)
    device = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_axes(param_axes) -> dict:
    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(tree, *, specs=None, grid=None) -> torch.Tensor:
    """The L2 norm over every leaf.  On a grid of ranks (``grid``) each
    leaf is the rank's block under its spec in ``specs``: its squares are
    summed over exactly the axes its spec claims (data, model, both), a
    whole leaf's counted once."""
    if grid is None or not specs or not any(specs.values()):
        leaves = tree.values() if isinstance(tree, dict) else tree
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves))
    from repro_torch.dist.sharding import axis_key

    groups: dict = {}
    for k, x in tree.items():
        axes = [a for part in specs.get(k, ()) if part is not None
                for a in (part if isinstance(part, tuple) else (part,))]
        key = axis_key(grid, tuple(axes)) if axes else "none"
        groups.setdefault(key, []).append(
            torch.sum(torch.square(x.to(torch.float32))))
    total = None
    for key in sorted(groups, key=str):
        sq = sum(groups[key])
        if key != "none":
            sq = grid.all_reduce(sq, axis=key)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig, *,
                  stacked=frozenset(), specs=None, grid=None):
    """One AdamW step, in place: ``params`` (dict name → tensor, or a
    module), m and v are overwritten.  Grads may be bf16 (accumulated); the
    math is float32.  ``stacked``: names that carry one more dim in the
    JAX package (its stacked layers); ``specs`` and ``grid``: the clip's
    norm over a grid of ranks (:func:`global_norm`).  Returns ``(state,
    metrics)``."""
    params = named(params)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, specs=specs, grid=grid)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=stepf.device)
              for b in (cfg.b1, cfg.b2))
    corr1, corr2 = 1 - b1 ** stepf, 1 - b2 ** stepf
    for k, p in params.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        delta = (m32 / corr1) / (torch.sqrt(v32 / corr2) + cfg.eps)
        if p.ndim + (k in stacked) >= 2:  # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return ({"m": opt_state["m"], "v": opt_state["v"], "step": step},
            {"lr": lr, "grad_norm": gnorm})


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: AdamWConfig

    def init(self, params) -> dict:
        return init_opt_state(params, self.cfg)

    def state_axes(self, param_axes) -> Any:
        return opt_state_axes(param_axes)

    def update(self, model, grads, state):
        """Updates ``model``'s parameters in place and drops its
        compute-dtype copies; returns ``(state, metrics)``."""
        grid = shd.grid_of(model.mesh)
        state, metrics = apply_updates(
            model, grads, state, self.cfg, stacked=model.stacked_names(),
            specs=model.leaf_specs() if grid is not None else None,
            grid=grid)
        model.params_changed()
        return state, metrics
