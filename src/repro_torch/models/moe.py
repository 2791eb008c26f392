"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py``. Each
(token, k) assignment is sorted by expert id, takes a slot in its expert's
``cap`` rows (``cap = max(1, int(1.25 * T * top_k / E))``) or, past them,
is dropped into one padded sink row; the experts run as batched products
over (E, cap, D) buffers, and the outputs are gathered back and weighted by
the gates.

Where JAX's result depends on an order, the port fixes the same one:
  - top-k keeps the lower expert index first among equal probabilities
    (``jax.lax.top_k``), here by a stable descending sort;
  - the assignments are sorted stably by expert id (``jnp.argsort`` is
    stable), which decides the ranks and so which assignments are dropped;
  - each token sums its top-k contributions one after another in its
    assignments' sorted order, in ``x.dtype``, as JAX's scatter-add does on
    the CPU; CUDA's ``index_add_`` would add them in any order.

``RECORD``: when a list, each call appends its routing (``expert_ids``
(T, top_k), ``keep`` (T * top_k,) in sorted order, ``cap``), tensors left
on the device, so that a caller can recount the drops on the host.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import block_norm, dense_init, init_norm, randn

#: routing of each ``apply_moe`` call while a list; None records nothing
RECORD: Optional[List[Dict[str, object]]] = None


def init_moe(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             num_experts: int, act: str, norm: str, dtype=torch.bfloat16,
             device=None) -> Dict[str, torch.Tensor]:
    E = num_experts

    def ed(a, b):
        # E expert matrices of dense_init's scale, drawn in one call
        return (randn(gen, (E, a, b), device) / math.sqrt(a)).to(dtype)

    p = {
        "router": dense_init(gen, d_model, E, torch.float32, device),
        "w_up": ed(d_model, d_ff),
        "w_down": ed(d_ff, d_model),
    }
    if act == "swiglu":
        p["w_gate"] = ed(d_model, d_ff)
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Slots per expert: JAX's ``max(1, int(capacity_factor * T * top_k /
    E))``, in the same float arithmetic."""
    return max(1, int(capacity_factor * tokens * top_k / num_experts))


def apply_moe(x: torch.Tensor, p: Dict[str, torch.Tensor], *, top_k: int,
              act: str, norm: str, capacity_factor: float = 1.25,
              shard_fn=lambda a, role=None: a) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) with residual."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    h = block_norm(x, p, norm)
    tokens = h.reshape(B * S, D)
    T = B * S

    logits = tokens.float() @ p["router"]                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the lower index first among equal values
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :top_k], expert_ids[:, :top_k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # flatten (token, k) assignments and sort by expert id
    flat_expert = expert_ids.reshape(-1)                        # (T*K,)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]

    # per-expert capacity slots; overflowing assignments are dropped
    cap = capacity(T, top_k, E, capacity_factor)
    ranks = _rank_in_group(sorted_expert)
    keep = ranks < cap
    sink = E * cap
    slot = torch.where(keep, sorted_expert * cap + ranks, sink)
    if RECORD is not None:
        RECORD.append({"expert_ids": expert_ids, "keep": keep, "cap": cap})

    # gather tokens into (E*cap, D) buffers (one padded sink row); every
    # dropped assignment writes zeros to the sink
    buf = torch.zeros((sink + 1, D), dtype=tokens.dtype, device=x.device)
    buf[slot] = torch.where(keep[:, None], tokens[sorted_token], 0.0
                            ).to(tokens.dtype)
    xe = shard_fn(buf[:-1].reshape(E, cap, D), role="experts")

    up = torch.bmm(xe, p["w_up"])
    if act == "swiglu":
        gate = torch.bmm(xe, p["w_gate"])
        inner = F.silu(gate.float()).to(x.dtype) * up
    else:
        # jax.nn.gelu's default is the tanh approximation
        inner = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    ye = shard_fn(torch.bmm(inner, p["w_down"]), role="experts")

    # gather back, weighted by the gates
    ye_flat = torch.cat([ye.reshape(sink, D),
                         torch.zeros((1, D), dtype=ye.dtype,
                                     device=x.device)])
    contrib = ye_flat[slot] * sorted_gate[:, None].to(ye.dtype)  # (T*K, D)
    # each token's K assignments, in their sorted (expert id) order
    by_token = contrib[torch.argsort(sorted_token, stable=True)
                       ].reshape(T, top_k, D).to(x.dtype)
    out = by_token[:, 0]
    for j in range(1, top_k):
        out = out + by_token[:, j]
    return x + shard_fn(out.reshape(B, S, D), role="boundary")


def _rank_in_group(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its (sorted) group: its index less the
    index where its group starts."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, device=sorted_ids.device)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - group_start


__all__ = ["init_moe", "apply_moe", "capacity", "RECORD"]
