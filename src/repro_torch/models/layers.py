"""Common layers: norms, initialisers, RoPE/M-RoPE, FFN.

Parameter-sharding roles (see core/exporter.py): every param dict here has a
matching entry in ``PARAM_ROLES[kind]`` so the exporter can emit
PartitionSpecs without inspecting the model.

The PyTorch counterpart of the JAX package's ``models/layers.py``, function
for function. ``PARAM_ROLES`` is a verbatim copy. Initialisers draw from an
explicit ``torch.Generator`` (or none, on the ``meta`` device) instead of a
JAX key, so their values differ from JAX's; shapes and dtypes are the same.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

# ----------------------------------------------------------------------
# sharding-role registry (kind -> param name -> role)
# ----------------------------------------------------------------------
PARAM_ROLES: Dict[str, Dict[str, str]] = {
    "embed": {"table": "table"},
    "head": {"w": "head"},
    "norm": {"scale": "replicate", "bias": "replicate"},
    "attn": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    },
    "cross_attn": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    },
    "enc_attn": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    },
    "ffn": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "w_gate": "col", "w_up": "col", "w_down": "row",
    },
    "enc_ffn": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "w_gate": "col", "w_up": "col", "w_down": "row",
    },
    "moe": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "router": "replicate",
        "w_gate": "expert", "w_up": "expert", "w_down": "expert",
    },
    "ssm": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "in_proj": "col", "conv_w": "expert", "conv_b": "expert",
        "x_proj": "row", "dt_proj": "col", "dt_bias": "expert",
        "a_log": "expert", "d_skip": "expert", "out_proj": "row",
    },
    "rwkv_tmix": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "mix_r": "replicate", "mix_k": "replicate", "mix_v": "replicate",
        "mix_g": "replicate", "mix_w": "replicate",
        "wr": "col", "wk": "col", "wv": "col", "wg": "col", "wo": "row",
        "decay": "expert", "bonus": "expert",
    },
    "rwkv_cmix": {
        "ln_scale": "replicate", "ln_bias": "replicate",
        "mix_k": "replicate", "mix_r": "replicate",
        "wk": "col", "wv": "row", "wr": "replicate",
    },
}


# ----------------------------------------------------------------------
# initialisers
# ----------------------------------------------------------------------

def randn(gen: Optional[torch.Generator], shape: Sequence[int],
          device=None) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` on ``device`` (the
    generator's own device when none is given)."""
    if device is None and gen is not None:
        device = gen.device
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (randn(gen, (d_in, d_out), device) * scale).to(dtype)


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype=torch.bfloat16,
              device=None) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def block_norm(x: torch.Tensor, params: Dict[str, torch.Tensor],
               kind: str) -> torch.Tensor:
    return apply_norm(x, params["ln_scale"], params.get("ln_bias"), kind)


# ----------------------------------------------------------------------
# RoPE / M-RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs            # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions_3d: (3, B, S) for (t, h, w);
    head_dim is split into three contiguous sections rotated by its own
    position stream (temporal gets half, spatial a quarter each)."""
    dh = x.shape[-1]
    s_t, s_h = dh // 2, dh // 4
    sections = [s_t, s_h, dh - s_t - s_h]
    outs = []
    start = 0
    for sec, pos in zip(sections, positions_3d):
        outs.append(apply_rope(x[..., start:start + sec], pos, theta))
        start += sec
    return torch.cat(outs, dim=-1)


# ----------------------------------------------------------------------
# FFN
# ----------------------------------------------------------------------

def init_ffn(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             act: str, norm: str, dtype=torch.bfloat16,
             device=None) -> Dict[str, torch.Tensor]:
    p = {}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["w_up"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["w_down"] = dense_init(gen, d_ff, d_model, dtype, device)
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def apply_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], act: str,
              norm: str, shard_fn=lambda a, role=None: a) -> torch.Tensor:
    h = block_norm(x, p, norm)
    up = h @ p["w_up"]
    if act == "swiglu":
        inner = F.silu((h @ p["w_gate"]).float()).to(x.dtype) * up
    elif act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        inner = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    else:  # relu_sq
        inner = torch.square(F.relu(up.float())).to(x.dtype)
    inner = shard_fn(inner, role="inner")
    out = inner @ p["w_down"]
    return x + shard_fn(out, role="boundary")
