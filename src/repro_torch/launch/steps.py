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
  place_model                a model's parameters as DTensors from its
                             specs

Sharded steps: on a mesh with a process group behind it
(``launch/mesh.make_mesh``, ``make_fake_mesh``) each ``make_*_step``
places the model's parameters as DTensors from ``Model.param_specs`` and
its step lays out the optimiser state, batch, boundary activations and
cache from their specs (``core/partition_spec.place``); the shard functions
redistribute at the folded tensors, where JAX constrains them, and AdamW
runs on each rank's shards (``_Layout``). The rwkv, ssm and
encoder-decoder kinds raise ``NotImplementedError`` there (ROADMAP Queue 1
item 15). On the 1 x 1 host mesh (no process group) every role is the
identity and the steps run on plain tensors, as before; a mesh of several
devices with no group is a shape for planning and raises ``ValueError``.

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

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.exporter import ShardingPlan, _axes
from repro_torch.core.partition_spec import PartitionSpec as P
from repro_torch.core.partition_spec import constrain, place, place_tree
from repro_torch.models.convert import flatten
from repro_torch.core.dtensor import (gather_last, is_dtensor,
                                     logsumexp_last)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_update

#: the block kinds a plan gives shard functions for (JAX's list)
KINDS = ("embed", "attn", "cross_attn", "enc_attn", "ffn", "enc_ffn", "moe",
         "ssm", "rwkv_tmix", "rwkv_cmix", "head", "norm")


#: the kinds whose sharded blocks are not ported yet: a step of a model
#: holding one is refused on a process group's mesh (``_layout``)
UNPORTED_KINDS = ("cross_attn", "enc_attn", "enc_ffn", "ssm", "rwkv_tmix",
                  "rwkv_cmix")
_UNPORTED = ("ROADMAP Queue 1 item 15: the sharded steps of the rwkv, ssm "
             "and encoder-decoder kinds")


def _identity(a, role=None):
    return a


def _device_mesh(mesh):
    """The ``DeviceMesh`` behind ``mesh``; None for a mesh of one device
    with no process group (the steps run on plain tensors). A mesh of
    several devices with no group is a shape for planning and raises."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None and mesh.size != 1:
        raise ValueError(
            f"a mesh of {mesh.size} devices with no process group behind it "
            f"is a shape for planning (make_production_mesh); steps run on "
            f"launch.mesh.make_mesh / make_fake_mesh")
    return dm


def shard_fns_from_plan(plan: ShardingPlan, mesh, partition: int = 0,
                        seq_parallel: bool = False) -> Dict[str, Callable]:
    """One function a block kind, applied at the folded tensors, JAX's
    ``steps.py:43-80``: by role, ``boundary`` (B, S, D) to ``P(b,
    sp_rows, None)``, ``inner`` to ``P(b, rows, c)``, ``heads`` (B, S, H,
    dh) to ``P(b, rows, c, None)`` and ``experts`` (E, cap, D) to ``P(c,
    None, None)``, from the kind's batch, rows and cols axes (decode rows
    None; ``seq_parallel`` shards the boundary's rows over the cols axes
    too). On a process group's mesh each is a ``DTensor.redistribute``
    (``constrain``). On a mesh of one device with no group every role is
    the identity."""
    if _device_mesh(mesh) is None:
        return {k: _identity for k in KINDS}
    decode = plan.mode == "decode"

    def fns_for(kind: str) -> Callable:
        kp = plan.kind_plan(kind, partition)
        b, r, c = _axes(kp.batch_axes), _axes(kp.rows_axes), \
            _axes(kp.cols_axes)
        rows = None if decode else r
        sp_rows = rows
        if seq_parallel and not decode:
            parts = tuple(x for t in (rows, c) if t is not None
                          for x in ((t,) if isinstance(t, str) else t))
            sp_rows = parts[0] if len(parts) == 1 else (parts or None)

        def fn(a, role=None):
            spec = None
            if role == "boundary" and a.ndim == 3:
                spec = P(b, sp_rows, None)
            elif role == "inner" and a.ndim == 3:
                spec = P(b, rows, c)
            elif role == "heads" and a.ndim == 4:
                spec = P(b, rows, c, None)
            elif role == "experts" and a.ndim == 3:
                spec = P(c, None, None)
            if spec is None:
                return a
            return constrain(a, mesh, spec)

        return fn

    return {k: fns_for(k) for k in KINDS}


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (a ``PartitionSpec``, None or
    a tensor is a leaf), ``rest`` trees of the same structure beside
    ``tree``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def place_model(model: Model, plan: ShardingPlan, mesh,
                partition: int = 0) -> Model:
    """Swaps each of ``model``'s parameters for a DTensor parameter laid
    out from ``model.param_specs(plan, partition)`` on ``mesh`` (in place;
    returns the model). A mesh with no process group leaves it as it
    is."""
    if _device_mesh(mesh) is None:
        return model
    specs = model.param_specs(plan, partition)
    for name, param in list(model.named_parameters()):
        path, leaf = name.rsplit(".", 1)
        spec = specs
        for k in name.split("."):
            spec = spec[k]
        placed = place(param.detach(), spec, mesh)
        model.get_submodule(path)[leaf] = torch.nn.Parameter(
            placed, requires_grad=param.requires_grad)
    return model


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


class _Layout:
    """Where a sharded step's inputs go on a process group's mesh: the
    model's parameters (placed when the step is built, ``place_model``),
    the optimiser state (``opt_state_specs``), the batch
    (``_batch_specs``), the boundary activations and cotangents
    (``plan.act_spec``) and the cache (``Model.cache_specs``). Each
    ``put_*`` lays out what it is given: plain tensors (the same on every
    rank) are sliced, DTensors redistributed where their layout differs.
    With no process group it is None (``_layout``)."""

    def __init__(self, model: Model, plan: ShardingPlan, mesh, partition,
                 zero1: bool, dp_axes: Tuple[str, ...]):
        self.mesh, self.plan, self.partition = mesh, plan, partition
        self.model = place_model(model, plan, mesh, partition)
        pspecs = model.param_specs(plan, partition)
        o = opt_state_specs(model.param_shapes(), pspecs, mesh, zero1,
                            dp_axes)
        self.ospecs = AdamWState(o.step, flatten(o.master), flatten(o.m),
                                 flatten(o.v))

    def put_state(self, state: AdamWState) -> AdamWState:
        return place_tree(state, self.ospecs, self.mesh)

    def put_batch(self, batch):
        specs = _batch_specs(self.plan, self.partition, tuple(batch))
        return place_tree(batch, specs, self.mesh)

    def put_act(self, a):
        return place(a, self.plan.act_spec(self.partition), self.mesh)

    def put_cache(self, cache):
        return place_tree(cache, self.model.cache_specs(
            self.plan, self.partition), self.mesh)

    def update(self, params, grads, state: AdamWState, lr: float):
        """AdamW over DTensors: the gradients go into the state's layout
        (an all-reduce, or with ZeRO-1 a reduce-scatter over the data
        axes), the update runs in place on each rank's shards (the clip
        takes the norm over all shards), and where ZeRO-1 shards the
        master but not the parameter, the new parameter is gathered back
        into the parameter's own shards (JAX's GSPMD does both moves
        from the step's in and out shardings)."""
        dm = self.mesh.device_mesh
        g, tmp = {}, {}
        for k, p in params.items():
            want = state.master[k].placements
            g[k] = grads[k].redistribute(dm, want)
            p = p.detach()
            tmp[k] = p if p.placements == want else p.redistribute(dm, want)
        _, new_state = adamw_update(tmp, g, state, lr=lr, donate=True)
        with torch.no_grad():
            for k, p in params.items():
                if tmp[k].placements != p.placements:
                    p.to_local().copy_(tmp[k].redistribute(
                        dm, p.placements).to_local())
        return new_state


def _layout(model: Model, plan: ShardingPlan, mesh, partition: int = 0,
            zero1: bool = False,
            dp_axes: Tuple[str, ...] = ("data",)) -> Optional[_Layout]:
    """The step's layout on a process group's mesh; None on the host
    mesh. A model holding a kind whose sharded block is not ported is
    refused here, when the step is built."""
    if _device_mesh(mesh) is None:
        return None
    unported = sorted({k for seg in model.segments for k in seg.pattern
                       if k in UNPORTED_KINDS})
    if unported:
        raise NotImplementedError(
            f"the {', '.join(unported)} block(s) on a process group's mesh "
            f"are not ported yet ({_UNPORTED})")
    return _Layout(model, plan, mesh, partition, zero1, dp_axes)


def _plain(t):
    """A replicated (or partial) DTensor as a plain tensor on every rank;
    a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _update_fn(layout: Optional[_Layout], lr: float):
    if layout is not None:
        return lambda params, grads, state: layout.update(params, grads,
                                                          state, lr)

    def update(params, grads, state):
        _, new_state = adamw_update({k: p.detach() for k, p in
                                     params.items()}, grads, state, lr=lr,
                                    donate=True)
        return new_state
    return update


def _no_graph(layout: Optional[_Layout]):
    """A serve step's grad mode: ``torch.inference_mode()``, or on a
    process group's mesh ``torch.no_grad()`` (a DTensor parameter cannot
    be indexed in inference mode)."""
    return torch.inference_mode() if layout is None else torch.no_grad()


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
    advanced.

    On a process group's mesh (``launch.mesh.make_mesh``) building the
    step places ``model``'s parameters as DTensors from the plan
    (``place_model``), and the step lays out the optimiser state
    (``opt_state_specs``: ``zero1`` shards it over ``dp_axes``) and the
    batch (each rank may pass the whole batch, or DTensors); the loss
    comes back as a plain tensor on every rank. On one device with no
    group ``zero1`` and ``dp_axes`` change nothing."""
    sf = shard_fns_from_plan(plan, mesh, partition, seq_parallel)
    layout = _layout(model, plan, mesh, partition, zero1, dp_axes)
    update = _update_fn(layout, lr)

    def step(opt_state: AdamWState, batch):
        batch = {k: batch[k] for k in batch_keys}
        if layout is not None:
            opt_state, batch = layout.put_state(opt_state), \
                layout.put_batch(batch)
        params = dict(model.named_parameters())
        with torch.enable_grad():
            loss = model.loss(batch, shard_fns=sf)
            grads = torch.autograd.grad(loss, list(params.values()))
        new_state = update(params, dict(zip(params, grads)), opt_state)
        return new_state, {"loss": _plain(loss.detach())}

    step.layout = layout
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
    general not its update. On a process group's mesh the parameters,
    state and batch are laid out as ``make_train_step``'s, the boundaries
    and cotangents from ``plan.act_spec`` and the labels from
    ``plan.data_spec``; boundaries and cotangents come back as DTensors."""
    sf = shard_fns_from_plan(plan, mesh, partition, seq_parallel)
    part = plan.partitions[partition]
    layout = _layout(model, plan, mesh, partition, zero1, dp_axes)
    _check_boundary_inputs(model, part,
                           part.has_head or not part.has_embed)
    update = _update_fn(layout, lr)
    params = dict(model.named_parameters())
    names, tensors = list(params), list(params.values())

    def put(opt_state, *acts):
        if layout is None:
            return (opt_state,) + acts
        return (layout.put_state(opt_state),) + tuple(
            layout.put_act(a) for a in acts)

    def fwd(x):
        return model({"tokens": None}, embedded=x, shard_fns=sf)[0]

    if part.has_head:
        def step(opt_state: AdamWState, boundary_in, labels):
            opt_state, boundary_in = put(opt_state, boundary_in)
            if layout is not None:
                labels = place(labels, plan.data_spec(partition), mesh)
            x = boundary_in.detach().requires_grad_(True)
            with torch.enable_grad():
                lf = fwd(x).float()
                logz = logsumexp_last(lf)
                gold = gather_last(lf, labels.long())
                loss = torch.mean(logz - gold)
                *gp, gx = torch.autograd.grad(loss, tensors + [x])
            return update(params, dict(zip(names, gp)), opt_state), gx, \
                {"loss": _plain(loss.detach())}
    elif part.has_embed:
        def step(opt_state: AdamWState, batch, cotangent_in):
            opt_state, cotangent_in = put(opt_state, cotangent_in)
            batch = {k: batch[k] for k in batch_keys}
            if layout is not None:
                batch = layout.put_batch(batch)
            with torch.enable_grad():
                h, _ = model(batch, shard_fns=sf)
                gp = torch.autograd.grad(h, tensors,
                                         grad_outputs=cotangent_in)
            return update(params, dict(zip(names, gp)), opt_state), \
                h.detach()
    else:
        def step(opt_state: AdamWState, boundary_in, cotangent_in):
            opt_state, boundary_in, cotangent_in = put(
                opt_state, boundary_in, cotangent_in)
            x = boundary_in.detach().requires_grad_(True)
            with torch.enable_grad():
                h = fwd(x)
                *gp, gx = torch.autograd.grad(h, tensors + [x],
                                              grad_outputs=cotangent_in)
            return update(params, dict(zip(names, gp)), opt_state), \
                h.detach(), gx

    step.layout = layout
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
    ``torch.inference_mode()``: it builds no autograd graph. On a process
    group's mesh the parameters are placed when the step is built, the
    step lays out the cache (``Model.cache_specs``; decode writes each
    rank's own shard at ``pos``) and the batch, and logits and cache come
    back as DTensors."""
    sf = shard_fns_from_plan(plan, mesh, partition)
    layout = _layout(model, plan, mesh, partition)
    no_graph = _no_graph(layout)

    def pick(cache, batch):
        batch = {k: batch[k] for k in batch_keys}
        if layout is not None:
            return layout.put_cache(cache), layout.put_batch(batch)
        return cache, batch

    if mode == "prefill":
        @no_graph
        def step(cache, batch):
            zero = torch.zeros((), dtype=torch.int32,
                               device=batch["tokens"].device)
            cache, batch = pick(cache, batch)
            return model(batch, cache=cache, cache_pos=zero,
                         shard_fns=sf, head_last_only=True)
    else:
        @no_graph
        def step(cache, batch, pos):
            cache, batch = pick(cache, batch)
            return model(batch, cache=cache, cache_pos=pos, shard_fns=sf)
    step.layout = layout
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
    only. Runs under ``torch.inference_mode()``. On a process group's
    mesh, laid out as ``make_serve_step``'s, a boundary from
    ``plan.act_spec``."""
    sf = shard_fns_from_plan(plan, mesh, partition)
    part = plan.partitions[partition]
    layout = _layout(model, plan, mesh, partition)
    _check_boundary_inputs(model, part, not part.has_embed)
    last = part.has_head and mode == "prefill"
    no_graph = _no_graph(layout)

    def run(cache, x_or_batch, pos):
        if part.has_embed:
            batch = {k: x_or_batch[k] for k in batch_keys}
            if layout is not None:
                cache, batch = layout.put_cache(cache), \
                    layout.put_batch(batch)
            return model(batch, cache=cache, cache_pos=pos, shard_fns=sf,
                         head_last_only=last)
        if layout is not None:
            cache, x_or_batch = layout.put_cache(cache), \
                layout.put_act(x_or_batch)
        return model({"tokens": None}, embedded=x_or_batch, cache=cache,
                     cache_pos=pos, shard_fns=sf, head_last_only=last)

    if mode == "prefill":
        @no_graph
        def step(cache, x_or_batch):
            x = x_or_batch["tokens"] if part.has_embed else x_or_batch
            zero = torch.zeros((), dtype=torch.int32, device=x.device)
            return run(cache, x_or_batch, zero)
    else:
        @no_graph
        def step(cache, x_or_batch, pos):
            return run(cache, x_or_batch, pos)
    step.layout = layout
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
