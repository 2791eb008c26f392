"""GQA self-attention with rotary positions.

The PyTorch counterpart of the JAX package's ``models/attention.py``. The
scaled-dot-product core (``sdpa``) dispatches to the hand-written
flash-attention kernel through ``kernels/ops.py`` (``impl="flash"``), to
the online-softmax oracle (``"chunked"``) or to the full-softmax oracle
(``"ref"``). Ported so far: the cache-less self-attention block. A decode
cache and cross-attention (``kv_src``) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (apply_mrope, apply_rope, block_norm,
                                       dense_init, init_norm)


def init_attention(gen: Optional[torch.Generator], d_model: int,
                   num_heads: int, num_kv_heads: int, head_dim: int,
                   norm: str, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         q_offset: int = 0, impl: str = "ref") -> torch.Tensor:
    """q: (B,Sq,H,dh) k,v: (B,Skv,Hkv,dh) -> (B,Sq,H,dh).

    impl: ref     — naive S x S softmax (oracle; O(S^2) memory)
          chunked — online softmax over KV blocks in plain PyTorch
          flash   — the hand-written CUDA kernel (its plain version on CPU
                    tensors)
    """
    if impl == "flash":
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "chunked":
        return ref.attention_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return ref.attention(q, k, v, causal=causal, q_offset=q_offset)


def attend(x: torch.Tensor, p: Dict[str, torch.Tensor], *,
           num_heads: int, num_kv_heads: int, head_dim: int,
           norm: str, causal: bool = True,
           positions: Optional[torch.Tensor] = None,
           rope_theta: float = 10000.0,
           mrope_positions: Optional[torch.Tensor] = None,
           kv_src: Optional[torch.Tensor] = None,
           cache: Optional[Dict[str, torch.Tensor]] = None,
           attn_impl: str = "ref",
           shard_fn=lambda a, role=None: a):
    """One self-attention block with pre-norm and residual. Returns
    (y, None): x plus the attention output, in x's dtype.

    positions        (B, S) rotary positions; None applies no rotation.
    mrope_positions  (3, B, S) multimodal positions, used instead of
                     ``positions`` when given.
    ``kv_src`` (cross-attention) and ``cache`` (decode) are not ported and
    raise."""
    if kv_src is not None:
        raise NotImplementedError(
            "cross-attention (kv_src) is not ported yet (ROADMAP Queue 1 "
            "item 13: the cross_attn and enc_* blocks)")
    if cache is not None:
        raise NotImplementedError(
            "a decode cache is not ported yet (ROADMAP Queue 1 items 13 and "
            "15: decode caches and the serve loop)")
    B, Sq, _ = x.shape
    h = block_norm(x, p, norm)
    q = (h @ p["wq"]).reshape(B, Sq, num_heads, head_dim)
    k = (h @ p["wk"]).reshape(B, Sq, num_kv_heads, head_dim)
    v = (h @ p["wv"]).reshape(B, Sq, num_kv_heads, head_dim)
    if positions is not None:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, rope_theta)
            k = apply_mrope(k, mrope_positions, rope_theta)
        else:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    q = shard_fn(q, role="heads")
    o = sdpa(q, k, v, causal=causal, impl=attn_impl)
    y = o.reshape(B, Sq, num_heads * head_dim) @ p["wo"]
    return x + shard_fn(y, role="boundary"), None


__all__ = ["init_attention", "sdpa", "attend"]
