"""The wrappers the models call around the LM kernels.

``flash_attention`` is the drop-in for ``ref.attention``: it hands the
model's (B, S, H, dh) tensors to the flash-attention kernel
(``flash_attention.flash_attention``), which reads that layout directly.
A decode-style call (a ``q_offset`` that is not the int 0) takes the
oracle, as the JAX wrapper does. ``rwkv6`` hands the model's (B, T, H, hs)
tensors to the WKV kernel (``rwkv6_scan.wkv6``). On CUDA tensors each
kernel wrapper launches its kernel or raises; on CPU tensors it runs the
kernel's plain version. Unlike the JAX wrappers these neither transpose nor
pad: the kernels take any sequence length and mask ragged tails themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref, rwkv6_scan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset=0) -> torch.Tensor:
    """Drop-in for ref.attention. q: (B, Sq, H, dh); k, v: (B, Skv, Hkv,
    dh). A non-zero or non-int ``q_offset`` (decode) goes to the oracle."""
    if not isinstance(q_offset, int) or q_offset != 0:
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    return _flash.flash_attention(q, k, v, causal=causal)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Drop-in for ref.rwkv6 (zero initial state; returns outputs only).

    r, k, v, w: (B, T, H, hs); u: (H, hs). w and u go to the kernel as
    float32."""
    return rwkv6_scan.wkv6(r, k, v, w.float(), u.float())


__all__ = ["flash_attention", "rwkv6"]
