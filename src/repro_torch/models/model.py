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

``batch`` keys: tokens, labels (+ frames for encdec, patch_embeds for
vlm).

``mesh=`` a grid of ranks (``dist.sharding.RankGrid``, or the dry run's
``TracedGrid``) holds each parameter at its local shape on the grid (its
``param_spec``: the JAX rules' spec under the grid's strategy, so FSDP on
the data axes and TENSOR, HEADS, KV_HEADS, VOCAB and EXPERT on ``model``
under ``"2d"``) and runs under ``activation_sharding(grid, rules,
batch=B)`` on the rank's rows of a global batch of B rows: FSDP dims are
gathered at use, the tensor-parallel ones computed Megatron's way
(``models/layers.py``); logits are the rank's vocabulary block and caches
its blocks.  The init from a seed gives each rank the block of the
one-process init.

``kernel="cuda"`` (the default) runs prefill and the forward pass through
the flash-attention and SSD chunk kernels — on CPU tensors their plain
versions, as every kernel entry point does; on the card it launches them
or raises, never falling back, and carries the gradient through them
(their ``autograd.Function``s) where one is asked for.  ``kernel="reference"`` runs the oracles of
``kernels/ref.py`` (tests and the smoke's comparison use it).  Decode is
plain PyTorch either way.  Prefill and decode read the weights in the
compute dtype: the model makes that copy of each weight once, at its first
prefill or decode step, keeps it (``compute_bytes``) and shares it with its
``with_kernel`` twins; ``init``, ``load_state_dict`` and an optimizer step
(:meth:`Model.params_changed`) drop it.  ``device="meta"`` builds the tree
without allocating it (``num_params``).  Parameters do not require grad;
``train.step`` asks for their gradients while it computes them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.common import ModelConfig

KERNELS = ("cuda", "reference")


class Model(L.ParamNode):
    def __init__(self, cfg: ModelConfig, *, kernel: str = "cuda",
                 device="cuda", mesh=None):
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if kernel == "cuda":
            check_kernel_shapes(cfg)
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        family = encdec if cfg.family == "encdec" else transformer
        super().__init__(children=family.build(cfg, device=dev, mesh=mesh))
        self.cfg = cfg
        self.kernel = kernel
        self.mesh = mesh
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

    def params_changed(self) -> None:
        """Drops the compute-dtype copies after the parameters changed in
        place (an optimizer step); the dict is cleared in place, so the
        ``with_kernel`` twins that share it see it too."""
        self._compute.clear()

    def stacked_names(self) -> set:
        """Names of the parameters the JAX package stacks on a leading
        layer axis (those under a ``Stack``): one dim more there, which the
        optimizer's decay rule counts."""
        out = set()
        for prefix, mod in self.named_modules():
            if isinstance(mod, transformer.Stack):
                out.update(f"{prefix}.{n}" for n, _ in mod.named_parameters())
        return out

    def num_params(self) -> int:
        """The parameters this process holds (its blocks on a grid)."""
        return sum(p.numel() for p in self.parameters())

    def leaf_specs(self) -> dict:
        """Each parameter's spec on the grid, by ``state_dict`` name (()
        for a whole one; every one off a grid)."""
        out = {}
        for prefix, mod in self.named_modules():
            if isinstance(mod, L.ParamNode):
                for k in mod._leaves:
                    out[f"{prefix}.{k}" if prefix else k] = mod.spec(k)
        return out

    def remesh(self, mesh, opt_state=None) -> None:
        """Re-lays the parameters (and ``opt_state``'s m and v, in place)
        from this model's grid onto ``mesh``, a survivor grid
        (``RankGrid.survivors``): every rank of the old grid calls it, the
        ranks outside ``mesh`` included — each leaf is gathered whole from
        every old rank's block (``ParamNode.relayout_``) and the rank keeps
        its block on ``mesh``.  The compute-dtype copies are dropped."""
        extra = () if opt_state is None else (opt_state["m"],
                                              opt_state["v"])
        new = None if getattr(mesh, "idle", False) else mesh
        self.relayout_(self.mesh, new, extra)
        self.mesh = mesh
        self._compute.clear()

    def with_kernel(self, kernel: str) -> "Model":
        """The same model (the very same parameters and compute-dtype
        copies) through ``kernel``."""
        twin = Model(self.cfg, kernel=kernel, device="meta", mesh=self.mesh)
        twin.load_state_dict(self.state_dict(keep_vars=True), assign=True)
        twin._compute = self._compute
        return twin

    def served(self) -> "Model":
        """The tree prefill and decode read: this model's parameters with
        each weight in the compute dtype (:func:`layers.compute_state`),
        made on the first call and kept."""
        tree = self._compute.get("tree")
        if tree is None:
            tree = Model(self.cfg, kernel=self.kernel, device="meta",
                         mesh=self.mesh)
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
        """``(logits, aux)``; differentiable (the train step's forward)."""
        if self.cfg.family == "encdec":
            return encdec.forward(self, batch["tokens"], batch["frames"],
                                  self.cfg, kernel=self.kernel)
        return transformer.forward(self, batch["tokens"], self.cfg,
                                   kernel=self.kernel,
                                   patch_embeds=batch.get("patch_embeds"))

    def train_loss(self, batch, *, parts=None):
        """The training loss of one batch (``train.step`` differentiates
        it); ``parts`` receives its cross-entropy and MoE terms."""
        if self.cfg.family == "encdec":
            return encdec.train_loss(self, batch, self.cfg,
                                     kernel=self.kernel, parts=parts)
        return transformer.train_loss(self, batch, self.cfg,
                                      kernel=self.kernel, parts=parts)

    # -- serve ----------------------------------------------------------------
    def prefill(self, batch, *, cache_len: int | None = None):
        if self.cfg.family == "encdec":
            return encdec.prefill(self.served(), batch["tokens"],
                                  batch["frames"], self.cfg,
                                  kernel=self.kernel, cache_len=cache_len)
        return transformer.prefill(self.served(), batch["tokens"], self.cfg,
                                   kernel=self.kernel, cache_len=cache_len,
                                   patch_embeds=batch.get("patch_embeds"))

    def decode_step(self, cache, token, pos: int):
        family = encdec if self.cfg.family == "encdec" else transformer
        return family.decode_step(self.served(), cache, token, pos, self.cfg)

    def init_cache(self, batch: int, cache_len: int):
        """The decode cache of a global batch of ``batch`` rows (on a grid,
        the rank's rows and blocks)."""
        family = encdec if self.cfg.family == "encdec" else transformer
        grid = shd.grid_of(self.mesh)
        if grid is not None and grid.rows_split(batch):
            batch //= grid.row_size
        return family.init_cache(self.cfg, batch, cache_len,
                                 self.embed.table.device, grid)


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
