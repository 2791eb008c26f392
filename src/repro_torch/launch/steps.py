"""Step functions from a SAMO ``ShardingPlan``: the serve half.

  make_serve_step   prefill (writes the KV/state cache, logits of the last
                    position) or decode (one token against the cache)

On one device every sharding role is the identity, so the plan only has
to be a one-device plan. A plan on a mesh of more than one device, the
train steps (``make_train_step``, ``make_partition_train_step``), the
weight-streaming ``make_partition_serve_step``, ZeRO-1 and the optimiser
specs are ROADMAP Queue 1 item 15 (the rest of launch) and item 14.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.exporter import ShardingPlan
from repro_torch.models.model import Model

#: the block kinds a plan gives shard functions for (JAX's list)
KINDS = ("embed", "attn", "cross_attn", "enc_attn", "ffn", "enc_ffn", "moe",
         "ssm", "rwkv_tmix", "rwkv_cmix", "head", "norm")


def _identity(a, role=None):
    return a


def shard_fns_from_plan(plan: ShardingPlan, mesh, partition: int = 0,
                        seq_parallel: bool = False) -> Dict[str, Callable]:
    """One function a block kind, applied at the folded tensors. On a mesh
    of one device every role is the identity; a larger mesh raises."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"a plan on a mesh of {mesh.size} devices is not ported yet: "
            f"the port serves on one device (ROADMAP Queue 1 item 15: "
            f"sharded steps and make_partition_serve_step)")
    return {k: _identity for k in KINDS}


def make_serve_step(model: Model, plan: ShardingPlan, mesh, mode: str,
                    max_len: int, partition: int = 0,
                    batch_keys: Tuple[str, ...] = ("tokens",)) -> Callable:
    """prefill: ``step(cache, batch) -> (logits_last, cache)``
       decode:  ``step(cache, batch, pos) -> (next_logits, cache)``

    The JAX step's arguments less the parameters, which the module holds;
    ``pos`` is a 0-d int32 tensor. Prefill writes from position 0 and
    returns the logits of the last position only. ``batch_keys`` names the
    batch entries the step reads; others are dropped."""
    sf = shard_fns_from_plan(plan, mesh, partition)

    def pick(batch):
        return {k: batch[k] for k in batch_keys}

    if mode == "prefill":
        def step(cache, batch):
            zero = torch.zeros((), dtype=torch.int32,
                               device=batch["tokens"].device)
            return model(pick(batch), cache=cache, cache_pos=zero,
                         shard_fns=sf, head_last_only=True)
    else:
        def step(cache, batch, pos):
            return model(pick(batch), cache=cache, cache_pos=pos,
                         shard_fns=sf)
    return step


__all__ = ["shard_fns_from_plan", "make_serve_step", "KINDS"]
