"""Step functions and their specs from a SAMO ``ShardingPlan``.

  make_train_step            full train step (loss -> grads -> AdamW) for
                             a partition that spans the whole graph
  make_partition_train_step  one partition of a multi-partition plan
                             (weight streaming): boundary activation in,
                             its cotangent out
  make_serve_step            prefill (writes the KV/state cache, logits of
                             the last position) or decode (one token
                             against the cache)
  make_partition_serve_step  one partition's prefill or decode step
  zero1_specs, opt_state_specs, batch_shardings
                             the ``PartitionSpec`` trees of the optimiser
                             state (ZeRO-1: sharded over the data-parallel
                             axes) and of a batch, beside
                             ``Model.param_specs`` / ``cache_specs``

On one device every sharding role is the identity, so the plan only has
to be a one-device plan, and ZeRO-1 is the identity for the arithmetic:
the specs are data that a sharded step reads. A plan on a mesh of more
than one device (sharded steps) is ROADMAP Queue 1 item 15.

Weight streaming: the plan's partition ``p`` runs in its own model,
``Model(arch, layer_range=(p.layer_start, p.layer_end),
include_embed=p.has_embed, include_head=p.has_head)``, as the JAX
package's dry run builds it; its weights are the full model's stacked
leaves sliced along the ``count`` axis. A caller runs the partitions'
steps one after another, the boundary activation (B, S, d_model) in the
model's dtype passing from each to the next: for training, forward over
0..P-1 (stashing the boundaries), then the steps P-1..0, each taking the
cotangent that the next returned. The boundary is the hidden state alone,
as in JAX: a partition after the first gets no ``mrope_positions`` (its
attention takes the plain rotary positions, as JAX's does), and a whisper
partition that would read ``frames`` or the encoder's output from its
boundary raises a ``ValueError`` naming it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.exporter import ShardingPlan, _axes
from repro_torch.core.partition_spec import PartitionSpec as P
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
            f"item 15: sharded steps)")
    return {k: _identity for k in KINDS}


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (a ``PartitionSpec``, None or
    a tensor is a leaf), ``rest`` trees of the same structure beside
    ``tree``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ----------------------------------------------------------------------
# ZeRO-1: shard fp32 optimiser state over the data-parallel axes
# ----------------------------------------------------------------------

def zero1_specs(param_shapes: Any, param_specs: Any, mesh,
                dp_axes: Tuple[str, ...] = ("data",)) -> Any:
    """Extend each param's PartitionSpec with the DP axes on the largest
    still-unsharded dim that divides evenly; leaves that cannot shard stay
    as-is (norm scales etc. — negligible bytes). Axes the spec already uses
    (a PartitionSpec may map each mesh axis once) are skipped.
    ``param_shapes`` holds tensors (``meta`` ones: ``Model.param_shapes()``)
    or anything with a ``shape``; ``mesh.shape`` gives each axis's size."""
    def extend(sds, spec):
        if spec is None:
            spec = P()
        entries = list(spec) + [None] * (len(sds.shape) - len(spec))
        used = set()
        for e in entries:
            if e is None:
                continue
            used.update((e,) if isinstance(e, str) else e)
        free = tuple(a for a in dp_axes if a not in used)
        if not free:
            return P(*entries) if entries else P()
        dp = 1
        for a in free:
            dp *= mesh.shape[a]
        dp_entry = free[0] if len(free) == 1 else free
        cands = [(d, sds.shape[d]) for d in range(len(sds.shape))
                 if entries[d] is None and sds.shape[d] % dp == 0
                 and sds.shape[d] >= dp]
        if not cands:
            return P(*entries) if entries else P()
        d = max(cands, key=lambda x: x[1])[0]
        entries[d] = dp_entry
        return P(*entries)

    return _tree_map(extend, param_shapes, param_specs)


def opt_state_specs(param_shapes: Any, param_specs: Any, mesh, zero1: bool,
                    dp_axes: Tuple[str, ...] = ("data",)) -> AdamWState:
    """An ``AdamWState`` of specs: the step replicated, the master, m and v
    as the parameters' specs, or ZeRO-1's (``zero1_specs``) with
    ``zero1``."""
    inner = (zero1_specs(param_shapes, param_specs, mesh, dp_axes)
             if zero1 else param_specs)
    return AdamWState(step=P(), master=inner,
                      m=_tree_map(lambda s: s, inner),
                      v=_tree_map(lambda s: s, inner))


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


def _check_boundary_inputs(model: Model, part, fed_boundary: bool) -> None:
    """A ``ValueError`` naming the input that a whisper partition's model
    would read and its boundary does not carry: ``frames`` where the
    partition runs the encoder from a boundary, the encoder's output
    where it runs cross-attention without the encoder. (JAX's partition
    steps fail on the first with a ``KeyError`` and run the second with
    cross-attention over the decoder's own tokens: ROADMAP Queue 3.)"""
    name = model.arch.name
    encoder = any(seg.encoder for seg in model.segments)
    if encoder and fed_boundary:
        raise ValueError(
            f"partition {part.index} of {name} runs the encoder, which "
            f"reads batch['frames'], but takes a boundary activation, "
            f"which carries the hidden state alone")
    if not encoder and any("cross_attn" in seg.pattern
                           for seg in model.segments):
        raise ValueError(
            f"partition {part.index} of {name} runs cross-attention, which "
            f"reads the encoder's output (enc_out), but holds no encoder "
            f"and its boundary carries the hidden state alone")


def make_partition_train_step(model: Model, plan: ShardingPlan, mesh,
                              partition: int, lr: float = 3e-4,
                              zero1: bool = False, seq_parallel: bool = False,
                              batch_keys: Tuple[str, ...] = ("tokens",),
                              dp_axes: Tuple[str, ...] = ("data",)
                              ) -> Callable:
    """Weight-streaming partition step of ``model``, the partition's own
    model (see the module docstring). Three flavours by position, JAX's
    less the parameters, which the module holds:

      first  (has embed):  step(opt_state, batch, cotangent_in)
                           -> (opt_state, boundary_out)
      middle:              step(opt_state, boundary_in, cotangent_in)
                           -> (opt_state, boundary_out, cotangent_out)
      last   (has head):   step(opt_state, boundary_in, labels)
                           -> (opt_state, cotangent_out, {"loss"})

    The last's loss is the float32 ``mean(logsumexp - gold)``; a step
    that holds the head is the last, whatever else it holds. Gradients
    come from ``torch.autograd.grad`` (``grad_outputs=cotangent_in``; the
    boundary in requires grad, so that its cotangent comes back), then
    ``adamw_update`` at ``lr`` in place, as ``make_train_step``'s. AdamW
    clips by the norm of the partition's own gradients, as JAX's step
    does, so a chain of partition steps gives the full graph's loss but in
    general not its update. ``zero1`` and ``dp_axes`` shard the optimiser
    state in JAX; on one device that is the identity."""
    sf = shard_fns_from_plan(plan, mesh, partition, seq_parallel)
    part = plan.partitions[partition]
    _check_boundary_inputs(model, part,
                           part.has_head or not part.has_embed)
    params = dict(model.named_parameters())
    names, tensors = list(params), list(params.values())

    def update(opt_state, grads):
        _, new_state = adamw_update(
            {k: p.detach() for k, p in params.items()},
            dict(zip(names, grads)), opt_state, lr=lr, donate=True)
        return new_state

    def fwd(x):
        return model({"tokens": None}, embedded=x, shard_fns=sf)[0]

    if part.has_head:
        def step(opt_state: AdamWState, boundary_in, labels):
            x = boundary_in.detach().requires_grad_(True)
            with torch.enable_grad():
                lf = fwd(x).float()
                logz = torch.logsumexp(lf, dim=-1)
                gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
                loss = torch.mean(logz - gold)
                *gp, gx = torch.autograd.grad(loss, tensors + [x])
            return update(opt_state, gp), gx, {"loss": loss.detach()}
    elif part.has_embed:
        def step(opt_state: AdamWState, batch, cotangent_in):
            with torch.enable_grad():
                h, _ = model({k: batch[k] for k in batch_keys}, shard_fns=sf)
                gp = torch.autograd.grad(h, tensors,
                                         grad_outputs=cotangent_in)
            return update(opt_state, gp), h.detach()
    else:
        def step(opt_state: AdamWState, boundary_in, cotangent_in):
            x = boundary_in.detach().requires_grad_(True)
            with torch.enable_grad():
                h = fwd(x)
                *gp, gx = torch.autograd.grad(h, tensors + [x],
                                              grad_outputs=cotangent_in)
            return update(opt_state, gp), h.detach(), gx

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


def make_partition_serve_step(model: Model, plan: ShardingPlan, mesh,
                              mode: str, max_len: int, partition: int,
                              batch_keys: Tuple[str, ...] = ("tokens",)
                              ) -> Callable:
    """Weight-streaming serve step of ``model``, the partition's own model
    with its own cache (``model.init_cache``); JAX's less the parameters:

      embed partition:  step(cache, batch[, pos]) -> (boundary, cache)
      middle partition: step(cache, boundary[, pos]) -> (boundary, cache)
      head partition:   step(cache, boundary[, pos]) -> (logits, cache)

    (the embed partition's flavour wins where it holds the head too).
    ``pos`` is a decode step's 0-d int32 position; a prefill writes from
    0, and a head partition's prefill returns the last position's logits
    only. Runs under ``torch.inference_mode()``."""
    sf = shard_fns_from_plan(plan, mesh, partition)
    part = plan.partitions[partition]
    _check_boundary_inputs(model, part, not part.has_embed)
    last = part.has_head and mode == "prefill"

    def run(cache, x_or_batch, pos):
        if part.has_embed:
            return model({k: x_or_batch[k] for k in batch_keys},
                         cache=cache, cache_pos=pos, shard_fns=sf,
                         head_last_only=last)
        return model({"tokens": None}, embedded=x_or_batch, cache=cache,
                     cache_pos=pos, shard_fns=sf, head_last_only=last)

    if mode == "prefill":
        @torch.inference_mode()
        def step(cache, x_or_batch):
            x = x_or_batch["tokens"] if part.has_embed else x_or_batch
            zero = torch.zeros((), dtype=torch.int32, device=x.device)
            return run(cache, x_or_batch, zero)
    else:
        @torch.inference_mode()
        def step(cache, x_or_batch, pos):
            return run(cache, x_or_batch, pos)
    return step


# ----------------------------------------------------------------------
# batch and logits specs
# ----------------------------------------------------------------------

def _batch_specs(plan: ShardingPlan, partition: int,
                 keys: Tuple[str, ...]) -> Dict[str, P]:
    data = plan.data_spec(partition)
    b_ax = data[0]
    r_ax = data[1] if plan.mode != "decode" else None

    def spec(name: str):
        if name in ("tokens", "labels"):
            return P(b_ax, r_ax)
        if name == "frames":
            return P(b_ax, None, None)
        if name == "mrope_positions":
            return P(None, b_ax, r_ax)
        return P()

    return {k: spec(k) for k in keys}


def batch_shardings(plan: ShardingPlan, mesh, batch_tree: Any,
                    partition: int = 0) -> Dict[str, P]:
    """Each batch key's spec (JAX returns each key's ``NamedSharding`` of
    it; the port has none, and on one device placing a batch is the
    identity)."""
    specs = _batch_specs(plan, partition, tuple(batch_tree))
    return {k: specs[k] for k in batch_tree}


def _logits_spec(plan: ShardingPlan, partition: int) -> P:
    """(B, S, V) logits: the head kind's OWN axes (its batch/cols subsets
    are disjoint by construction; mixing kinds can duplicate a mesh axis)."""
    kp = plan.kind_plan("head", partition)
    return P(_axes(kp.batch_axes), None, _axes(kp.cols_axes))


__all__ = ["shard_fns_from_plan", "make_train_step",
           "make_partition_train_step", "make_serve_step",
           "make_partition_serve_step", "zero1_specs", "opt_state_specs",
           "batch_shardings", "KINDS"]
