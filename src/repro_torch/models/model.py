"""The model API, as in the JAX package's ``models/model.py``, with the
parameters held by the model (an ``nn.Module`` tree)::

    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    axes = model.axes()                        # the JAX logical-axes tree
    logits, aux = model.forward(batch)         # batch: dict of tensors
    loss = model.train_loss(batch)
    logits, cache = model.prefill(batch, cache_len=...)
    logits, cache = model.decode_step(cache, token, pos)
    cache, cache_axes = model.init_cache(batch_size, cache_len)

``batch`` keys: tokens, labels (+ patch_embeds for the vlm family).

``kernel="cuda"`` (the default) runs prefill and the forward pass through
the flash-attention and SSD chunk kernels — on CPU tensors their plain
versions, as every kernel entry point does; on the card it launches them
or raises, never falling back.  ``kernel="reference"`` runs the oracles of
``kernels/ref.py`` (tests and the smoke's comparison use it).  Decode is
plain PyTorch either way.  Prefill and decode read the weights in the
compute dtype: the model makes that copy of each weight once, at its first
prefill or decode step, keeps it (``compute_bytes``) and shares it with its
``with_kernel`` twins; ``init`` and ``load_state_dict`` drop it.  ``device="meta"`` builds the tree without
allocating it (``num_params``).  The families ``moe`` and ``encdec`` are
ROADMAP Queue A item 14b's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.plug.protocols import not_ported_error

KERNELS = ("cuda", "reference")


class Model(L.ParamNode):
    def __init__(self, cfg: ModelConfig, *, kernel: str = "cuda",
                 device="cuda"):
        if cfg.family in ("moe", "encdec"):
            raise not_ported_error(f"the {cfg.family} family ({cfg.name})", 14)
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if kernel == "cuda":
            check_kernel_shapes(cfg)
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        super().__init__(children=transformer.build(cfg, device=dev))
        self.cfg = cfg
        self.kernel = kernel
        # the served tree (compute-dtype copies), made at first use
        self._compute: dict = {}

    # -- parameters ----------------------------------------------------------
    def init(self, gen: torch.Generator) -> "Model":
        """Fills every parameter from ``gen`` (on the parameters' device)."""
        self._compute.clear()
        self.init_(gen)
        return self

    def load_state_dict(self, state_dict, *args, **kwargs):
        self._compute.clear()
        return super().load_state_dict(state_dict, *args, **kwargs)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def with_kernel(self, kernel: str) -> "Model":
        """The same model (the very same parameters and compute-dtype
        copies) through ``kernel``."""
        twin = Model(self.cfg, kernel=kernel, device="meta")
        twin.load_state_dict(self.state_dict(keep_vars=True), assign=True)
        twin._compute = self._compute
        return twin

    def served(self) -> "Model":
        """The tree prefill and decode read: this model's parameters with
        each weight in the compute dtype (:func:`layers.compute_state`),
        made on the first call and kept."""
        tree = self._compute.get("tree")
        if tree is None:
            tree = Model(self.cfg, kernel=self.kernel, device="meta")
            nn.Module.load_state_dict(
                tree, L.compute_state(self, self.cfg.tdtype),
                assign=True)
            self._compute["tree"] = tree
        return tree

    def compute_bytes(self) -> int:
        """Bytes of the kept compute-dtype copies (0 before the first
        prefill or decode, or when the compute dtype is the parameters')."""
        tree = self._compute.get("tree")
        if tree is None:
            return 0
        own = {p.data_ptr() for p in self.parameters()}
        return sum(p.numel() * p.element_size() for p in tree.parameters()
                   if p.data_ptr() not in own)

    # -- train ----------------------------------------------------------------
    def forward(self, batch):
        return transformer.forward(self, batch["tokens"], self.cfg,
                                   kernel=self.kernel,
                                   patch_embeds=batch.get("patch_embeds"))

    def train_loss(self, batch):
        """The training loss of one batch, forward only (the backward pass
        and the optimizer are item 14b's)."""
        return transformer.train_loss(self, batch, self.cfg,
                                      kernel=self.kernel)

    # -- serve ----------------------------------------------------------------
    def prefill(self, batch, *, cache_len: int | None = None):
        return transformer.prefill(self.served(), batch["tokens"], self.cfg,
                                   kernel=self.kernel, cache_len=cache_len,
                                   patch_embeds=batch.get("patch_embeds"))

    def decode_step(self, cache, token, pos: int):
        return transformer.decode_step(self.served(), cache, token, pos,
                                       self.cfg)

    def init_cache(self, batch: int, cache_len: int):
        return transformer.init_cache(self.cfg, batch, cache_len,
                                      self.embed.table.device)


def check_kernel_shapes(cfg: ModelConfig) -> None:
    """Refuses a configuration the model kernels are not built for: the
    attention head dim (``flash_attention.HEAD_DIMS``) and the SSD head dim
    P (``ssd_scan.HEAD_DIMS``)."""
    if cfg.family != "ssm" and cfg.resolved_head_dim not in kfa.HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: head_dim={cfg.resolved_head_dim}, but the flash "
            f"attention kernels take {kfa.HEAD_DIMS}")
    if cfg.family in ("ssm", "hybrid"):
        S.check_head_dim(cfg)
