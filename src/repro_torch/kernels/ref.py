"""Plain PyTorch oracles for the LM kernels.

The PyTorch counterparts of the JAX package's ``kernels/ref.py``:

  attention          GQA attention with a causal mask offset by
                     ``q_offset``, the full S x S softmax in float32; the
                     plain version of the flash-attention kernel
                     (``csrc/flash_attn.cu``)
  attention_chunked  the same function by online softmax over KV blocks
                     (peak memory O(S x block_k)), ``sdpa(impl="chunked")``
  rwkv6              the plain version of the WKV kernel (``csrc/wkv6.cu``):
                     the sequential recurrence, one time step at a time, in
                     float32
  rmsnorm            RMS normalisation in float32, back in x's dtype
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _kv_heads(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, Hkv * group, dh) in float32: query head h
    reads KV head h // group (``jnp.repeat`` along the head axis)."""
    return torch.repeat_interleave(x.float(), group, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset=0) -> torch.Tensor:
    """Reference GQA attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh). Returns (B, Sq, H, dh) in
    q's dtype. ``q_offset`` is the absolute position of q[0] (decode: cache
    write pos); a key at position kpos is seen by a query at qpos when
    kpos <= qpos.
    """
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    kf, vf = _kv_heads(k, group), _kv_heads(v, group)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(dh)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos), -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset=0,
                      block_k: int = 1024, with_lse: bool = False):
    """Online-softmax attention, looped over KV blocks of ``block_k``.

    Matches ``attention`` to float32 accumulation error with peak memory
    O(Sq x block_k) instead of O(Sq x Skv). A row that no key of the blocks
    seen so far may read keeps m = -inf; its exponent is guarded, and a row
    with no key at all outputs 0.
    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh). ``with_lse`` also returns
    each row's float32 log-sum-exp of its scores, (B, H, Sq), -inf for a
    row with no key (for combining attention over key shards).
    """
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float() / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset   # (Sq, 1)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, block_k):
        kb = _kv_heads(k[:, k0:k0 + block_k], group)    # (B, bk, H, dh)
        vb = _kv_heads(v[:, k0:k0 + block_k], group)
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)     # (B, H, Sq, bk)
        valid = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
        s = s.masked_fill(~valid, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    out = out.transpose(1, 2).to(q.dtype)               # (B, Sq, H, dh)
    if with_lse:
        return out, torch.where(l == 0.0, -torch.inf,
                                m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return out


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference WKV6 recurrence (Finch, data-dependent decay).

    r, k, v, w: (B, T, H, hs); u: (H, hs) bonus. state: (B, H, hs, hs) or None.
    Per step (head h):  out_t = r_t @ (S + u ⊙ k_t v_t^T)
                        S    <- diag(w_t) S + k_t v_t^T
    with w_t already the decay multiplier in (0, 1).
    Returns (out (B,T,H,hs) in r's dtype, final_state (B,H,hs,hs) float32).
    """
    B, T, H, hs = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    if state is None:
        S = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    else:
        S = state.float()
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B,H,hs,hs)
        att = S + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], att))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype), S


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x / rms(x) * scale over the last dimension, in float32 (JAX's
    ``ref.rmsnorm``)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


__all__ = ["attention", "attention_chunked", "rwkv6", "rmsnorm"]
