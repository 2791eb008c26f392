"""Gradient-compression collectives (distributed-optimisation tricks).

The port's counterpart of the JAX package's ``optim/compression.py``, over
``torch.distributed`` where JAX uses a named mesh axis:

  int8 quantised all-reduce — 4x traffic cut on the DP gradient ring:
      q = round(g / scale) with stochastic rounding; all-reduce q in int32;
      dequantise. The SAMO collective model exposes this as
      ModelOptions.grad_compression = 0.25.

  top-k sparsification — keep the k largest-|g| entries (error feedback left
      to the caller); traffic ~ 2k/n of dense.

Stochastic rounding draws its uniforms from a ``torch.Generator`` (JAX's
from a PRNG key); without one, values round to the nearest integer, ties
to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _quantise(gf: torch.Tensor, scale: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    x = gf / scale
    if generator is not None:
        x = torch.floor(x + torch.rand(x.shape, generator=generator,
                                       dtype=torch.float32,
                                       device=x.device))
    else:
        x = torch.round(x)
    return torch.clamp(x, -127, 127)


def compress_int8(g: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (int8 tensor, fp32 scale). Stochastic rounding when a
    generator is given."""
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    return _quantise(gf, scale, generator).to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(g: torch.Tensor, group=None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """int8-quantised all-reduce over the ``torch.distributed`` ``group``
    (None: the default group).

    A shared scale (the max over members of each member's absmax) makes
    the int32 sum an exact sum of the quantised values; rings <= 2^24
    members cannot overflow. Returns the mean gradient."""
    import torch.distributed as dist
    gf = g.float()
    local_max = torch.max(torch.abs(gf))
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(local_max, min=1e-12) / 127.0
    total = _quantise(gf, scale, generator).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return (total.float() * scale) / n


def topk_sparsify(g: torch.Tensor, k_fraction: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (values, flat indices) of the top-|g| k_fraction entries."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * k_fraction))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_densify(values: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    out = torch.zeros((math.prod(shape),), dtype=values.dtype,
                      device=values.device)
    return out.index_put((idx,), values).reshape(tuple(shape))


__all__ = ["compress_int8", "decompress_int8", "compressed_psum",
           "topk_sparsify", "topk_densify"]
