"""Meta-tensor input specs per (arch × shape) — the dry-run contract, as in
the JAX package's ``launch/specs.py``.

Where JAX hands ``jit`` ``ShapeDtypeStruct``s, the port hands its step
tensors on the ``meta`` device: they carry shape and dtype, and nothing is
allocated or computed.  ``input_specs`` returns them for every model input
with their logical axes: train batches, prefill prompts, and decode (token
+ KV/SSM cache + position).  Parameters are the meta ``Model``'s own, keyed
by ``state_dict`` name — the JAX package's stacked layers unstacked, as
``convert.model_params_from_jax`` names them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.dist import sharding as shd
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class SpecSet:
    args: Any  # tree of meta tensors
    axes: Any  # parallel tree of logical-axis tuples


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: Shape, *,
                with_labels: bool) -> SpecSet:
    b, s = shape.global_batch, shape.seq_len
    args = {"tokens": _meta((b, s), torch.int32)}
    axes = {"tokens": (shd.BATCH, None)}
    if with_labels:
        args["labels"] = _meta((b, s), torch.int32)
        axes["labels"] = (shd.BATCH, None)
    if cfg.family == "encdec":
        args["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cfg.tdtype)
        axes["frames"] = (shd.BATCH, None, None)
    if cfg.family == "vlm":
        args["patch_embeds"] = _meta((b, cfg.num_patches, cfg.d_model),
                                     cfg.tdtype)
        axes["patch_embeds"] = (shd.BATCH, None, None)
    return SpecSet(args, axes)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> SpecSet:
    """The decode cache of a meta model (no allocation) and its axes."""
    cache, axes = Model(cfg, device="meta").init_cache(batch, cache_len)
    return SpecSet(cache, axes)


def param_axes(model: Model) -> dict:
    """Each parameter's logical axes, keyed by ``state_dict`` name (a
    stacked JAX leaf's axes without their leading ``"layers"``)."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, leaf in getattr(mod, "_leaves", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = tuple(leaf.axes)
    return out


def params_specs(cfg: ModelConfig) -> SpecSet:
    model = Model(cfg, device="meta")
    return SpecSet(dict(model.named_parameters()), param_axes(model))


def decode_specs(cfg: ModelConfig, shape: Shape) -> dict[str, SpecSet]:
    b = shape.global_batch
    token = SpecSet(_meta((b, 1), torch.int32), (shd.BATCH, None))
    pos = SpecSet(_meta((), torch.int32), ())
    # the encoder-decoder's decode re-reads the stub encoder memory through
    # the cross-KV cache, which cache_specs holds (xk/xv)
    return {"token": token, "pos": pos,
            "cache": cache_specs(cfg, b, shape.seq_len)}


def input_specs(cfg: ModelConfig, shape: Shape) -> dict[str, SpecSet]:
    """All meta stand-ins the step of a cell takes."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# memory-driven microbatch choice (Lemma-1 analog at the training level)
# --------------------------------------------------------------------------
def choose_microbatches(cfg: ModelConfig, shape: Shape, *, data_shards: int,
                        activation_budget: int = 4 << 30) -> int:
    """Smallest microbatch count whose per-device scan carry fits the budget.

    Saved state per layer per microbatch ≈ B_local × S × d_model × 2 bytes
    (bf16 residual carry, remat saves nothing else); total × num_layers.
    """
    if shape.kind != "train":
        return 1
    b_local = max(1, shape.global_batch // data_shards)
    per_layer = shape.seq_len * cfg.d_model * 2
    total = cfg.num_layers * per_layer
    mb = 1
    while mb < b_local and (b_local // mb) * total > activation_budget:
        mb *= 2
    while b_local % mb:
        mb //= 2
    return max(1, mb)
