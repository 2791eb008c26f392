"""Architecture configuration schema.

Every assigned architecture is an ``ArchConfig`` instance. The config is the
"customised IR" input to SAMO's parser (core/graph_builder.py), and also what
the model zoo (models/model.py) instantiates. ``ShapeSpec`` captures the
assigned input-shape cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    """Static description of one architecture (exact assigned dims)."""

    name: str
    family: str                    # dense | hybrid | ssm | vlm | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0           # 0 => dense FFN
    experts_per_token: int = 0
    moe_period: int = 1            # every `moe_period`-th FFN is MoE (jamba: 2)
    first_layer_dense: bool = False  # kimi-k2 style: layer 0 dense FFN

    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 1           # 1 => all layers attention; 8 => 1:7 attn:mamba
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- rwkv ---
    rwkv_head_size: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0        # 0 => decoder-only
    cross_attention: bool = False

    # --- modality frontend (stubbed: input_specs provides embeddings) ---
    frontend: str = "none"         # none | audio_stub | vision_stub
    num_frames: int = 0            # whisper: 1500 precomputed frame embeddings
    mrope: bool = False            # qwen2-vl 3D multimodal RoPE position ids

    # --- misc ---
    act: str = "swiglu"            # swiglu | gelu | relu_sq
    norm: str = "rms"              # rms | ln
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k is runnable (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Sequence-mixer kind of layer i: 'attn' | 'ssm' | 'rwkv'."""
        if self.family == "ssm":
            return "rwkv"
        if self.attn_period > 1:
            # jamba: one attention layer per attn_period block (position
            # attn_period-1 inside each block), rest mamba.
            return "attn" if (i % self.attn_period) == (self.attn_period - 1) else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """Channel-mixer kind of layer i: 'moe' | 'ffn'."""
        if not self.is_moe:
            return "ffn"
        if self.first_layer_dense and i == 0:
            return "ffn"
        return "moe" if (i % self.moe_period) == (self.moe_period - 1) else "ffn"

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        dh, Hkv = self.head_dim, self.num_kv_heads
        total = V * D                       # embedding
        if not self.tie_embeddings:
            total += V * D                  # lm head
        n_ffn_mats = 3 if self.act == "swiglu" else 2
        layers = self.num_layers + self.encoder_layers
        for i in range(self.num_layers):
            total += self._mixer_params(self.layer_kind(i))
            if self.ffn_kind(i) == "moe":
                total += self.num_experts * n_ffn_mats * D * F + D * self.num_experts
            else:
                f = F if not (self.is_moe and not self.first_layer_dense) else F
                total += n_ffn_mats * D * f
            total += 2 * D                  # norms
        for i in range(self.encoder_layers):
            total += self._mixer_params("attn") + n_ffn_mats * D * F + 2 * D
            if self.cross_attention:
                total += self._mixer_params("attn")  # decoder cross-attn (approx)
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_ffn_mats = 3 if self.act == "swiglu" else 2
        total = self.param_count()
        for i in range(self.num_layers):
            if self.ffn_kind(i) == "moe":
                total -= (self.num_experts - self.experts_per_token) * n_ffn_mats * D * F
        return total

    def _mixer_params(self, kind: str) -> int:
        D, dh, Hkv, H = self.d_model, self.head_dim, self.num_kv_heads, self.num_heads
        if kind == "attn":
            return D * (H * dh) + 2 * D * (Hkv * dh) + (H * dh) * D
        if kind == "ssm":
            di, ds = self.ssm_expand * self.d_model, self.ssm_d_state
            dt_rank = max(1, self.d_model // 16)
            return (D * 2 * di + di * self.ssm_conv + di * (dt_rank + 2 * ds)
                    + dt_rank * di + di * ds + di + di * D)
        if kind == "rwkv":
            # time-mix: r,k,v,g,o projections + decay params; channel-mix
            # counted separately by the ffn entry (rwkv cmix uses d_ff).
            return 5 * D * D + 2 * D
        raise ValueError(kind)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.mode == "train"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention (skip for pure full-attention)."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


def reduced(arch: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(arch.num_layers, 4 if arch.attn_period <= 1 else arch.attn_period),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(arch.num_kv_heads, 2) if arch.num_kv_heads < arch.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        num_experts=min(arch.num_experts, 4),
        experts_per_token=min(arch.experts_per_token, 2),
        encoder_layers=min(arch.encoder_layers, 2),
        num_frames=min(arch.num_frames, 16) if arch.num_frames else 0,
        rwkv_head_size=32,
    )
    if arch.attn_period > 1:
        small["num_layers"] = 2 * arch.attn_period  # keep the interleave pattern
    small.update(overrides)
    return dataclasses.replace(arch, **small)
