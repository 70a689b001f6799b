"""Model configuration shared by all architecture families.

One dataclass covers the 10 assigned architectures; the ``family`` field
selects the stack:

  dense  — decoder-only transformer (GQA, RoPE, SwiGLU or GELU)
  moe    — dense skeleton with MoE FFN layers (top-k routed experts)
  ssm    — Mamba2 (SSD) attention-free stack
  hybrid — Mamba2 backbone + a *shared* attention block every
           ``attn_every`` layers (Zamba2)
  encdec — encoder-decoder with cross attention (Whisper); audio frontend
           stubbed as precomputed frame embeddings
  vlm    — decoder backbone consuming precomputed patch embeddings fused
           into the token stream (Pixtral; ViT frontend stubbed)

The port's copy of the JAX package's ``models/common.py``: the same fields
and derived values, with torch dtypes (``tdtype``, ``tparam_dtype``) in
place of ``jdtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    activation: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 → d_ff)
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4: one always-on shared expert

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1  # B/C projection groups

    # hybrid (Zamba2)
    attn_every: int = 6  # shared attention block period

    # encdec (Whisper)
    num_encoder_layers: int = 0
    encoder_seq: int = 1500  # stubbed conv frontend output length

    # vlm (Pixtral)
    num_patches: int = 0  # stubbed ViT output length

    # numerics
    param_dtype: str = "float32"
    dtype: str = "bfloat16"

    # embedding-table padding: vocab rounded up so the vocab dim shards
    # evenly (GPT-NeoX/MaxText practice). Logits over padding columns are
    # masked to -inf; labels never reference them.
    vocab_pad_multiple: int = 32

    # distribution / memory knobs (per-arch defaults; shapes may override)
    remat: bool = True
    scan_layers: bool = True
    # backward-pass wire precision: round cotangents through bf16 at layer
    # boundaries (halves gradient-collective volume; §Perf A1)
    bf16_cotangent: bool = False
    # embedding lookup as one-hot matmul instead of gather: GSPMD partitions
    # the matmul cleanly where the gather replicates (B,S,D) (§Perf A4);
    # worth it when batch shards wider than the vocab table
    iota_embed: bool = False

    # --- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def tdtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def tparam_dtype(self) -> torch.dtype:
        """The parameters' dtype as a torch dtype."""
        return getattr(torch, self.param_dtype)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM state decode, not KV-quadratic)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter counting (for 6·N·D roofline sanity) ---------------------
    def param_counts(self) -> dict[str, int]:
        d, hd = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads
        counts: dict[str, int] = {}
        counts["embed"] = self.padded_vocab * d
        counts["unembed"] = 0 if self.tie_embeddings else self.padded_vocab * d

        def attn_params() -> int:
            p = d * (h * hd) + 2 * d * (hkv * hd) + (h * hd) * d
            if self.qkv_bias:
                p += (h + 2 * hkv) * hd
            return p

        def dense_ff() -> int:
            if self.activation == "swiglu":
                return 3 * d * self.d_ff
            return 2 * d * self.d_ff

        if self.family in ("dense", "vlm"):
            counts["attn"] = self.num_layers * attn_params()
            counts["ffn"] = self.num_layers * dense_ff()
            counts["norms"] = self.num_layers * 2 * d + d
            if self.family == "vlm":
                counts["patch_proj"] = d * d
        elif self.family == "moe":
            eff = self.moe_d_ff or self.d_ff
            per_expert = 3 * d * eff if self.activation == "swiglu" else 2 * d * eff
            counts["attn"] = self.num_layers * attn_params()
            counts["router"] = self.num_layers * d * self.num_experts
            counts["experts"] = self.num_layers * self.num_experts * per_expert
            if self.shared_expert:
                counts["shared_expert"] = self.num_layers * dense_ff()
            counts["norms"] = self.num_layers * 2 * d + d
        elif self.family == "ssm":
            counts["ssm"] = self.num_layers * self._ssm_block_params()
            counts["norms"] = self.num_layers * d + d
        elif self.family == "hybrid":
            counts["ssm"] = self.num_layers * self._ssm_block_params()
            counts["shared_attn"] = attn_params() + dense_ff() + 2 * d
            counts["norms"] = self.num_layers * d + d
        elif self.family == "encdec":
            enc = self.num_encoder_layers * (attn_params() + dense_ff() + 2 * d)
            dec = self.num_layers * (2 * attn_params() + dense_ff() + 3 * d)
            counts["encoder"] = enc
            counts["decoder"] = dec
            counts["enc_pos"] = self.encoder_seq * d
            counts["norms"] = 2 * d
        return counts

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        nh, g = self.ssm_heads, self.ssm_groups
        in_proj = d * (2 * di + 2 * g * n + nh)  # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * g * n)  # depthwise conv over x,B,C
        extra = 3 * nh + di  # A_log, dt_bias, D skip, gated-norm scale
        out_proj = di * d
        return in_proj + conv + extra + out_proj

    def num_params(self) -> int:
        return sum(self.param_counts().values())

    def num_active_params(self) -> int:
        """Active (per-token) params — differs from total for MoE."""
        if self.family != "moe":
            return self.num_params()
        c = self.param_counts()
        eff = self.moe_d_ff or self.d_ff
        per_expert = (3 if self.activation == "swiglu" else 2) * self.d_model * eff
        active_experts = self.num_layers * self.experts_per_token * per_expert
        return (self.num_params() - c["experts"]) + active_experts
