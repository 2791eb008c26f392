"""Step functions from a SAMO ``ShardingPlan``.

  make_train_step   full train step (loss -> grads -> AdamW) for a
                    partition that spans the whole graph
  make_serve_step   prefill (writes the KV/state cache, logits of the last
                    position) or decode (one token against the cache)

On one device every sharding role is the identity, so the plan only has
to be a one-device plan, and ZeRO-1 (the optimiser state sharded over the
data-parallel axes) is the identity too. A plan on a mesh of more than one
device, the weight-streaming steps (``make_partition_train_step``,
``make_partition_serve_step``) and the optimiser's partition specs
(``zero1_specs``, ``opt_state_specs``) are ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.exporter import ShardingPlan
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_update

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
            f"the port trains and serves on one device (ROADMAP Queue 1 "
            f"item 15: sharded steps and the weight-streaming steps)")
    return {k: _identity for k in KINDS}


def make_train_step(model: Model, plan: ShardingPlan, mesh,
                    partition: int = 0, lr: float = 3e-4,
                    zero1: bool = False, seq_parallel: bool = False,
                    batch_keys: Tuple[str, ...] = ("tokens", "labels"),
                    dp_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """Full-graph train step: ``step(opt_state, batch) -> (opt_state,
    metrics)``, metrics ``{"loss"}`` (a 0-d float32 tensor on the device).

    The JAX step's arguments less the parameters, which the module holds:
    the loss of ``model`` on the batch entries named by ``batch_keys``,
    its gradients by autograd (grad mode is switched on for the step),
    then ``adamw_update`` at ``lr``. The step donates its inputs, as JAX's
    jitted step does: the new parameters go into the module's tensors and
    the new state into ``opt_state``'s, which is returned with its step
    advanced. ``zero1`` and ``dp_axes`` shard the optimiser state over
    the data-parallel axes in JAX; on one device that is the identity."""
    sf = shard_fns_from_plan(plan, mesh, partition, seq_parallel)

    def step(opt_state: AdamWState, batch):
        params = dict(model.named_parameters())
        with torch.enable_grad():
            loss = model.loss({k: batch[k] for k in batch_keys},
                              shard_fns=sf)
            grads = torch.autograd.grad(loss, list(params.values()))
        _, new_state = adamw_update(
            {k: p.detach() for k, p in params.items()},
            dict(zip(params, grads)), opt_state, lr=lr, donate=True)
        return new_state, {"loss": loss.detach()}

    return step


def make_serve_step(model: Model, plan: ShardingPlan, mesh, mode: str,
                    max_len: int, partition: int = 0,
                    batch_keys: Tuple[str, ...] = ("tokens",)) -> Callable:
    """prefill: ``step(cache, batch) -> (logits_last, cache)``
       decode:  ``step(cache, batch, pos) -> (next_logits, cache)``

    The JAX step's arguments less the parameters, which the module holds;
    ``pos`` is a 0-d int32 tensor. Prefill writes from position 0 and
    returns the logits of the last position only. ``batch_keys`` names the
    batch entries the step reads; others are dropped. A step runs under
    ``torch.inference_mode()``: it builds no autograd graph."""
    sf = shard_fns_from_plan(plan, mesh, partition)

    def pick(batch):
        return {k: batch[k] for k in batch_keys}

    if mode == "prefill":
        @torch.inference_mode()
        def step(cache, batch):
            zero = torch.zeros((), dtype=torch.int32,
                               device=batch["tokens"].device)
            return model(pick(batch), cache=cache, cache_pos=zero,
                         shard_fns=sf, head_last_only=True)
    else:
        @torch.inference_mode()
        def step(cache, batch, pos):
            return model(pick(batch), cache=cache, cache_pos=pos,
                         shard_fns=sf)
    return step


__all__ = ["shard_fns_from_plan", "make_train_step", "make_serve_step",
           "KINDS"]
