"""The wrapper the models call around the LM kernels.

``rwkv6`` hands the model's (B, T, H, hs) tensors to the WKV kernel
(``rwkv6_scan.wkv6``), which reads that layout directly: on CUDA tensors it
launches the kernel or raises; on CPU tensors it runs the kernel's plain
version. Unlike the JAX wrapper it neither transposes nor pads time to a
chunk: the kernel takes any T.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rwkv6_scan


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Drop-in for ref.rwkv6 (zero initial state; returns outputs only).

    r, k, v, w: (B, T, H, hs); u: (H, hs). w and u go to the kernel as
    float32."""
    return rwkv6_scan.wkv6(r, k, v, w.float(), u.float())


__all__ = ["rwkv6"]
