"""Plain PyTorch oracles for the LM kernels.

``rwkv6`` is the plain version of the WKV kernel (``csrc/wkv6.cu``): the
sequential recurrence, one time step at a time, in float32. The attention
oracles come with the flash-attention kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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


__all__ = ["rwkv6"]
