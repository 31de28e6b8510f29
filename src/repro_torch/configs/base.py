"""Architecture + shape configuration schema (``repro/configs/base.py``).

Every assigned architecture is an :class:`ArchConfig`; its layer stack is
described by a repeating *pattern unit* of :class:`LayerSpec`s. The
reference scans over stacked units; the port runs the same layers in
execution order (layer ``u * unit_len + p`` is unit ``u``'s position
``p``). Shapes are the four assigned input shapes; ``applies`` encodes the
brief's skip rules (encoder-only ⇒ no decode; pure full attention ⇒ no
long_500k). Pure Python, apart from ``param_dtype``, a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                  # "attn" | "mamba" | "mlstm" | "slstm"
    mlp: str                   # "dense" | "moe" | "none"
    window: Optional[int] = None   # sliding-window width (None = full)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # moe|ssm|audio|hybrid|dense|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1         # MoE MLP on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25  # expert capacity = cf·T·k/E (cf≥E/k ⇒ dropless)
    # attention flavour
    sliding_window: Optional[int] = None
    local_global_period: int = 0   # gemma2: alternate local/global (period 2)
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    activation: str = "silu"
    head_dim: Optional[int] = None
    # hybrid / recurrent
    attn_period: int = 0       # jamba: 1 attn per `attn_period` layers
    attn_offset: int = 0
    ssm_kind: Optional[str] = None   # "mamba" | "xlstm"
    # encoder-decoder / multimodal
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0       # fixed encoder memory length (whisper: 1500)
    is_prefix_lm: bool = False
    prefix_len: int = 0        # paligemma: image patch tokens
    frontend: Optional[str] = None   # "audio_stub" | "patch_stub"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def mlp_kind(self, i: int) -> str:
        if self.d_ff == 0:
            return "none"
        if self.n_experts and (i % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense"

    def layer_kind(self, i: int) -> Tuple[str, Optional[int]]:
        """(kind, window) of decoder layer ``i``."""
        if self.ssm_kind == "xlstm":
            return ("mlstm" if i % 2 == 0 else "slstm"), None
        if self.ssm_kind == "mamba":
            if self.attn_period and (i % self.attn_period) == self.attn_offset:
                return "attn", self.sliding_window
            return "mamba", None
        if self.local_global_period:
            local = (i % self.local_global_period) == 0
            return "attn", (self.sliding_window if local else None)
        return "attn", self.sliding_window

    @property
    def unit_len(self) -> int:
        """Length of the repeating pattern unit (for scan-over-units)."""
        if self.ssm_kind == "xlstm":
            return 2
        if self.ssm_kind == "mamba" and self.attn_period:
            return self.attn_period
        if self.local_global_period:
            return self.local_global_period
        if self.n_experts and self.moe_every > 1:
            return self.moe_every
        return 1

    def unit(self) -> List[LayerSpec]:
        u = self.unit_len
        assert self.n_layers % u == 0, (self.name, self.n_layers, u)
        return [LayerSpec(kind=self.layer_kind(i)[0], mlp=self.mlp_kind(i),
                          window=self.layer_kind(i)[1]) for i in range(u)]

    @property
    def n_units(self) -> int:
        return self.n_layers // self.unit_len

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid/linear-attn or every-layer
        bounded-window structure (DESIGN.md §6 skip rules)."""
        if self.ssm_kind:
            return True
        if self.local_global_period:
            return True   # gemma2: global-layer KV sequence-sharded
        return self.sliding_window is not None

    @property
    def param_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> float:
        """Total parameters (embedding included once; analytic)."""
        d, f = self.d_model, self.d_ff
        attn = 2 * d * self.n_heads * self.d_head \
            + 2 * d * self.n_kv_heads * self.d_head
        total = 0.0
        for i in range(self.n_layers):
            kind, _ = self.layer_kind(i)
            if kind == "attn":
                total += attn
            elif kind == "mamba":
                di = 2 * d
                total += d * 2 * di + di * (d // 16 + 32) \
                    + (d // 16) * di + di * d
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + d * d
            mlp = self.mlp_kind(i)
            if mlp == "dense":
                # gated (SwiGLU/GeGLU) MLPs have 3 matrices; squared-ReLU
                # (nemotron) has up+down only
                total += (2 if self.activation == "sq_relu" else 3) * d * f
            elif mlp == "moe":
                total += d * self.n_experts + 3 * d * f * self.n_experts
            total += 2 * d
        if self.is_encdec:
            enc_attn = 4 * d * d + 3 * d * f + 2 * d
            total += self.encoder_layers * enc_attn
            total += self.n_layers * (4 * d * d)     # cross-attention
        total += self.vocab * d
        return total

    def n_active_params(self) -> float:
        """Active parameters per token (MoE: only top-k experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dead = 0.0
        for i in range(self.n_layers):
            if self.mlp_kind(i) == "moe":
                dead += 3 * d * f * (self.n_experts - self.top_k)
        return self.n_params() - dead


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode" | "long_decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}


def shape_applies(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Brief's skip rules. Returns (applies, reason_if_not)."""
    if shape.kind == "long_decode" and not arch.sub_quadratic:
        return False, "SKIP(full-attn): long_500k needs sub-quadratic attention"
    return True, ""
