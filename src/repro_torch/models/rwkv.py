"""RWKV6 (Finch) blocks: time-mix (WKV attention-free mixer with
data-dependent decay) and channel-mix (squared-relu FFN with receptance).

The PyTorch counterpart of the JAX package's ``models/rwkv.py``. The WKV
recurrence dispatches to the hand-written kernel through
``kernels/ops.py`` (``use_kernel``) or to the oracle ``kernels/ref.py``;
a carried ``state`` (decode) always takes the oracle, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import block_norm, dense_init, init_norm, randn


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} stream: shift right by one; `prev` is the carry for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1) \
        if x.shape[1] > 1 else prev[:, None, :]


def init_rwkv_tmix(gen: Optional[torch.Generator], d_model: int,
                   head_size: int, norm: str, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    H = d_model // head_size

    def full(value, dt):
        return torch.full((d_model,), value, dtype=dt, device=device)

    p = {
        "wr": dense_init(gen, d_model, d_model, dtype, device),
        "wk": dense_init(gen, d_model, d_model, dtype, device),
        "wv": dense_init(gen, d_model, d_model, dtype, device),
        "wg": dense_init(gen, d_model, d_model, dtype, device),
        "wo": dense_init(gen, d_model, d_model, dtype, device),
        "decay": full(-4.0, torch.float32),           # base log-log decay
        "bonus": randn(gen, (H, head_size), device) * 0.1,
        "mix_r": full(0.5, dtype),
        "mix_k": full(0.5, dtype),
        "mix_v": full(0.5, dtype),
        "mix_g": full(0.5, dtype),
        "mix_w": full(0.5, dtype),
    }
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def apply_rwkv_tmix(x: torch.Tensor, p: Dict[str, torch.Tensor], *,
                    head_size: int, norm: str,
                    state: Optional[Dict[str, torch.Tensor]] = None,
                    use_kernel: bool = False,
                    shard_fn=lambda a, role=None: a):
    """state (decode): {"shift": (B,D), "wkv": (B,H,hs,hs) fp32}.
    Returns (y, new_state). y is the residual sum x + out in float32: the
    JAX reference's compiled program keeps that sum unrounded for the norm
    of the channel mix that reads it, and rounds it only for the channel
    mix's own residual add (``apply_rwkv_cmix``)."""
    B, S, D = x.shape
    H = D // head_size
    h = block_norm(x, p, norm)
    prev = state["shift"] if state is not None else None
    h_prev = _token_shift(h, prev)

    def mix(m):
        return h * m + h_prev * (1.0 - m)

    r = (mix(p["mix_r"]) @ p["wr"]).reshape(B, S, H, head_size)
    k = (mix(p["mix_k"]) @ p["wk"]).reshape(B, S, H, head_size)
    v = (mix(p["mix_v"]) @ p["wv"]).reshape(B, S, H, head_size)
    g = mix(p["mix_g"]) @ p["wg"]
    # data-dependent decay in (0, 1): w = exp(-exp(decay + f(x))) per channel
    w_raw = p["decay"][None, None] + mix(p["mix_w"]).float() * 0.01
    w = torch.exp(-torch.exp(w_raw)).reshape(B, S, H, head_size)

    if state is not None:
        # decode: single recurrent step against the carried WKV state
        out, wkv = ref.rwkv6(r, k, v, w, p["bonus"], state["wkv"])
    elif use_kernel:
        out = ops.rwkv6(r, k, v, w, p["bonus"])
        wkv = None
    else:
        out, wkv = ref.rwkv6(r, k, v, w, p["bonus"])

    out = out.reshape(B, S, D) * F.silu(g.float()).to(x.dtype)
    y = shard_fn(out @ p["wo"], role="boundary")
    new_state = None
    if state is not None:
        new_state = {"shift": h[:, -1], "wkv": wkv}
    return x.float() + y.float(), new_state


def init_rwkv_cmix(gen: Optional[torch.Generator], d_model: int, d_ff: int,
                   norm: str, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    p = {
        "wk": dense_init(gen, d_model, d_ff, dtype, device),
        "wv": dense_init(gen, d_ff, d_model, dtype, device),
        "wr": dense_init(gen, d_model, d_model, dtype, device),
        "mix_k": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "mix_r": torch.full((d_model,), 0.5, dtype=dtype, device=device),
    }
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def apply_rwkv_cmix(x: torch.Tensor, p: Dict[str, torch.Tensor], *,
                    norm: str, state: Optional[Dict[str, torch.Tensor]] = None,
                    shard_fn=lambda a, role=None: a):
    """state (decode): {"shift": (B, D)}. Returns (y, new_state).
    x may come in float32 above the parameters' dtype (the time mix's
    unrounded residual sum): the norm reads it as it is, and the residual
    add rounds it to the parameters' dtype first, as XLA's program does."""
    dt = p["wk"].dtype
    h = block_norm(x, p, norm).to(dt)
    x = x.to(dt)
    prev = state["shift"] if state is not None else None
    h_prev = _token_shift(h, prev)
    hk = h * p["mix_k"] + h_prev * (1.0 - p["mix_k"])
    hr = h * p["mix_r"] + h_prev * (1.0 - p["mix_r"])
    k = torch.square(F.relu((hk @ p["wk"]).float())).to(x.dtype)
    k = shard_fn(k, role="inner")
    vv = k @ p["wv"]
    r = torch.sigmoid((hr @ p["wr"]).float()).to(x.dtype)
    new_state = {"shift": h[:, -1]} if state is not None else None
    return x + shard_fn(r * vv, role="boundary"), new_state
