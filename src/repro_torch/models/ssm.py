"""Mamba-style selective SSM block (jamba's sequence mixer).

The PyTorch counterpart of the JAX package's ``models/ssm.py``, in plain
PyTorch (the JAX block has no Pallas kernel either). The recurrence
``h_t = a_t * h_{t-1} + b_t`` runs as a log-depth (Hillis-Steele) scan of
the pair combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)`` over the
time axis, block by block: each block of tokens is scanned in parallel and
hands its last state to the next, folded into that block's first step
(``b_0 += a_0 h``). So a carried state (decode, or a prefill into a cache)
takes the same route as a cache-less forward and never walks the sequence
one host step at a time, where JAX scans a carried state step by step
(``lax.scan``) and a fresh one with ``lax.associative_scan``: the same
function, summed in another order. A block holds at most ``SCAN_BLOCK``
elements of each (B, tokens, di, d_state) float32 tensor, so the scan's
memory does not grow with the sequence (JAX holds all three of ``a``,
``b`` and ``h`` whole: 1 MiB a token a layer at jamba's width).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import block_norm, dense_init, init_norm, randn

#: the most elements of each (B, tokens, di, d_state) float32 tensor that
#: one block of the scan holds (256 MiB a tensor)
SCAN_BLOCK = 1 << 26


def init_ssm(gen: Optional[torch.Generator], d_model: int, expand: int,
             d_state: int, d_conv: int, norm: str, dtype=torch.bfloat16,
             device=None) -> Dict[str, torch.Tensor]:
    di = expand * d_model
    dtr = max(1, d_model // 16)
    p = {
        "in_proj": dense_init(gen, d_model, 2 * di, dtype, device),
        "conv_w": (randn(gen, (di, d_conv), device) * 0.1).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, di, dtr + 2 * d_state, dtype, device),
        "dt_proj": dense_init(gen, dtr, di, dtype, device),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=device)
        ).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d_model, dtype, device),
    }
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All states ``h_t = a_t h_{t-1} + b_t`` (h before the first step 0)
    along axis 1 of (B, n, di, ds) ``a`` and ``b``: Hillis-Steele, log2(n)
    levels of the pair combine, each into a new tensor (autograd keeps the
    old ones)."""
    n, d = a.shape[1], 1
    while d < n:
        nb = b.clone()
        nb[:, d:].addcmul_(a[:, d:], b[:, :-d])
        if 2 * d < n:
            na = a.clone()
            na[:, d:].mul_(a[:, :-d])
            a = na
        b, d = nb, 2 * d
    return b


def _ssm_core(x: torch.Tensor, p: Dict[str, torch.Tensor], d_state: int,
              state: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, di). Returns (y (B, S, di) in x's dtype, final state
    (B, di, ds) float32); ``state`` (B, di, ds) is the state before x."""
    B, S, di = x.shape
    dtr = p["dt_proj"].shape[0]
    xdbc = (x @ p["x_proj"]).float()                        # (B,S,dtr+2ds)
    dt_in, Bc, Cc = torch.split(xdbc, [dtr, d_state, d_state], dim=-1)
    # softplus(x) = log(1 + e^x), as JAX's logaddexp(x, 0); past F.softplus's
    # threshold of 20 the two differ by under 2e-9, below float32 rounding
    dt = F.softplus(dt_in @ p["dt_proj"].float()
                    + p["dt_bias"].float())                  # (B,S,di)
    A = -torch.exp(p["a_log"])                               # (di, ds)
    xf = x.float()
    h = state.float() if state is not None else None
    step = max(1, SCAN_BLOCK // max(1, B * di * d_state))
    ys = []
    for t0 in range(0, S, step):
        sl = slice(t0, t0 + step)
        a = torch.exp(dt[:, sl, :, None] * A)                # (B,n,di,ds)
        b = (dt[:, sl, :, None] * Bc[:, sl, None, :]) * xf[:, sl, :, None]
        if h is not None:
            b[:, 0] += a[:, 0] * h                           # fold h in
        hs = _scan(a, b)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cc[:, sl]))
        h = hs[:, -1]
        del a, b, hs
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + p["d_skip"][None, None] * xf
    return y.to(x.dtype), h


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S + dc - 1, di); w: (di, dc) -> (B, S, di): the outputs from
    position dc - 1 on, where JAX's rolled sum is valid. The dc shifted
    multiply-adds are written out (not ``F.conv1d``), summed in JAX's order
    in x's dtype, so a bfloat16 model rounds each step as JAX's op-by-op
    program does."""
    dc = w.shape[1]
    S = x.shape[1] - (dc - 1)
    out = None
    for i in range(dc):
        term = x[:, i:i + S] * w[:, i][None, None, :]
        out = term if out is None else out + term
    return out + b[None, None, :]


def apply_ssm(x: torch.Tensor, p: Dict[str, torch.Tensor], *, d_state: int,
              d_conv: int, norm: str,
              state: Optional[Dict[str, torch.Tensor]] = None,
              shard_fn=lambda a, role=None: a):
    """One mamba block with pre-norm and residual.

    state (decode): {"ssm": (B, di, ds) float32, "conv": (B, d_conv - 1,
    di)}, the SSM state and the last inputs of the causal conv before x.
    Returns (y, new_state), new_state {"ssm", "conv"} after x with or
    without a ``state``, as JAX's. The conv history takes the dtype of
    ``[history ; xi]`` (float32 after a float32 model's prefill into a
    bfloat16 cache, as in JAX)."""
    B, S, D = x.shape
    h = block_norm(x, p, norm)
    xz = h @ p["in_proj"]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    xi = shard_fn(xi, role="inner")

    # causal depthwise conv over [history ; xi]
    dc = p["conv_w"].shape[1]
    if state is not None:
        hist = state["conv"]
        dt = torch.promote_types(hist.dtype, xi.dtype)
        xpad = torch.cat([hist.to(dt), xi.to(dt)], dim=1)
    else:
        xpad = torch.cat([xi.new_zeros((B, dc - 1, di)), xi], dim=1)
    new_hist = xpad[:, xpad.shape[1] - (dc - 1):]
    xc = _causal_depthwise_conv(xpad, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)

    y, ssm_state = _ssm_core(xc, p, d_state,
                             state["ssm"] if state is not None else None)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ p["out_proj"]
    new_state = {"ssm": ssm_state, "conv": new_hist}
    return x + shard_fn(out, role="boundary"), new_state


__all__ = ["init_ssm", "apply_ssm", "SCAN_BLOCK"]
