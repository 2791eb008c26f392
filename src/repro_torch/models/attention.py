"""GQA self-attention with rotary positions.

The PyTorch counterpart of the JAX package's ``models/attention.py``. The
scaled-dot-product core (``sdpa``) dispatches to the hand-written
flash-attention kernel through ``kernels/ops.py`` (``impl="flash"``), to
the online-softmax oracle (``"chunked"``) or to the full-softmax oracle
(``"ref"``). Ported so far: the self-attention block, cache-less or
against a decode cache. Cross-attention (``kv_src``) raises
``NotImplementedError``.

The decode cache is written in place: this step's K/V go into the
caller's buffers at ``cache_pos`` and the returned cache holds the same
tensors. JAX's ``attend`` returns a new cache instead, and its serve loop
donates the old one, so nothing of the caller sees the difference; a
caller that wants the old cache again clones it first.
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
           cache_pos: Optional[torch.Tensor] = None,
           attn_impl: str = "ref",
           shard_fn=lambda a, role=None: a):
    """One self-attention block with pre-norm and residual. Returns
    (y, new_cache): x plus the attention output, in x's dtype.

    positions        (B, S) rotary positions; None applies no rotation.
    mrope_positions  (3, B, S) multimodal positions, used instead of
                     ``positions`` when given.
    cache            {"k", "v"}: (B, L, Hkv, dh) decode caches. With
                     ``cache_pos`` (an int or a 0-d integer tensor) this
                     step's K/V are written at that position, cast to the
                     cache's dtype, in place, and the queries attend over
                     the whole cache from ``q_offset = cache_pos``. Without
                     it the new cache is this step's K/V in the cache's
                     dtype.
    ``kv_src`` (cross-attention) is not ported and raises."""
    if kv_src is not None:
        raise NotImplementedError(
            "cross-attention (kv_src) is not ported yet (ROADMAP Queue 1 "
            "item 13d: the cross_attn and enc_* blocks)")
    B, Sq, _ = x.shape
    h = block_norm(x, p, norm)
    q = (h @ p["wq"]).reshape(B, Sq, num_heads, head_dim)
    k = (h @ p["wk"]).reshape(B, Sq, num_kv_heads, head_dim)
    v = (h @ p["wv"]).reshape(B, Sq, num_kv_heads, head_dim)
    if positions is not None:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, rope_theta)
            k = apply_mrope(k, mrope_positions[:, :, :Sq]
                            if mrope_positions.shape[-1] != Sq
                            else mrope_positions, rope_theta)
        else:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions[:, :Sq]
                           if positions.shape[-1] != Sq else positions,
                           rope_theta)
    new_cache = cache
    if cache is not None and cache_pos is not None:
        # prefill/decode: insert this step's K/V at cache_pos
        k = _write(cache["k"], k, cache_pos)
        v = _write(cache["v"], v, cache_pos)
    elif cache is not None:
        new_cache = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    q = shard_fn(q, role="heads")
    q_offset = cache_pos if cache_pos is not None else 0
    o = sdpa(q, k, v, causal=causal, q_offset=q_offset, impl=attn_impl)
    y = o.reshape(B, Sq, num_heads * head_dim) @ p["wo"]
    return x + shard_fn(y, role="boundary"), new_cache


def _write(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """``buf[:, pos:pos + S] = new`` in place, in buf's dtype, with the
    start clamped to [0, L - S] as ``dynamic_update_slice`` clamps it; a
    tensor ``pos`` stays on the device (no host sync). Returns buf."""
    S, L = new.shape[1], buf.shape[1]
    idx = torch.arange(S, device=buf.device)
    if isinstance(pos, int):
        idx = idx + min(max(pos, 0), L - S)
    else:
        idx = idx + pos.to(buf.device).clamp(0, L - S)
    return buf.index_copy_(1, idx, new.to(buf.dtype))


__all__ = ["init_attention", "sdpa", "attend"]
