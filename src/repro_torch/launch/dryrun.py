"""Dry run: every (architecture x shape x mesh) cell's sharded steps built
and run on fake tensors over a fake process group, with each device's
FLOPs, bytes, collectives and peak memory counted from the port's own
program, and the roofline terms of the H100.

The PyTorch counterpart of the JAX package's ``launch/dryrun.py``. For
each cell:

  1. SAMO optimises the mapping (rule-based, spmd backend, latency
     objective, ZeRO-1) on the port's torch engine, on the card (K1) or
     on the CPU when asked -> ``ShardingPlan`` (several partitions for a
     model over the mapper's HBM: weight streaming, paper §III-B).
  2. Each UNIQUE partition signature's step (``launch/steps.py``, the
     sharded train or serve step on the plan's specs) is built and run
     once under ``FakeTensorMode`` on the 16 x 16 (or 2 x 16 x 16) mesh
     of a 512-rank fake group (``launch/mesh.make_fake_mesh``): no memory
     is allocated and no byte moves. Attention takes the chunked oracle,
     as JAX's default (``use_flash=False``) does: a hand-written kernel
     cannot run on fake tensors.
  3. A dispatch mode beneath DTensor's dispatch (``Counter``) sees each
     rank's local ops: FLOPs by ``torch.utils.flop_counter``'s formulas,
     the operand and result bytes of each op that is not a view, the
     operand bytes a rank sends into each collective, by kind (JAX's
     convention, ``dryrun.py:96-117``), and the peak of the live local
     storages, the step's arguments included and donated (in-place)
     arguments counted once: JAX's ``temp + argument + output - alias``.
     Every op that runs is counted, so the counts are exact
     (``cost_method`` "counted"): JAX's unrolled cost probes exist only
     because XLA counts a while body once.
  4. Everything lands in a per-cell JSON (JAX's keys) under
     ``experiments/dryrun_torch/``.

The roofline's peaks are the H100 SXM's (``roofline_terms``'s keyword
arguments); the fit check reads the plan's platform (``hbm_bytes`` of the
mapping target), which is data of the mapper.

The rwkv, ssm and encoder-decoder kinds have no sharded step yet: their
partitions record the ``NotImplementedError`` that names the ROADMAP item,
as JAX's record a partition that fails, and ``--all`` exits 1.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch, \
    shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.accel import segred
from repro_torch.core.backends import BACKENDS
from repro_torch.core.dtensor import local
from repro_torch.core.exporter import export_plan
from repro_torch.core.graph_builder import build_hdgraph
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers import rule_based
from repro_torch.core.perfmodel import ModelOptions
from repro_torch.core.platform import Platform
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.shapes import input_specs
from repro_torch.launch.steps import (make_partition_serve_step,
                                      make_partition_train_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import resolve_device

#: the card the roofline is drawn for, and its published peaks (NVIDIA's
#: H100 SXM data sheet, dense rates, at its 700 W limit)
CARD = "NVIDIA H100 SXM (80 GB HBM3)"
PEAK_FLOPS = 989.4e12        # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s one way, NVLink 4 (900 GB/s both ways)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: c10d functional op name -> JAX's collective kind
_C10D_KIND = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
              ("reduce_scatter", "reduce-scatter"),
              ("all_to_all", "all-to-all"), ("broadcast", "collective-permute"),
              ("permute", "collective-permute"))


# ----------------------------------------------------------------------
# counting each rank's local ops
# ----------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(local(x))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return out


#: the ShardingPropagator method that runs an op on fake global tensors
#: to derive its output's shape, by PyTorch version (newest first)
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


@contextmanager
def _propagation_marked(counter: "Counter"):
    """DTensor derives each op's output shape by running the op on fake
    global tensors (``ShardingPropagator``); those runs are no rank's
    work, so the counter skips what runs inside them: the propagator's
    method that runs them is wrapped to raise the counter's flag while it
    runs, and put back after."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next((n for n in _PROPAGATORS
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError(
            f"this PyTorch's DTensor has none of ShardingPropagator."
            f"{_PROPAGATORS}: the dry run cannot tell sharding propagation "
            f"from a rank's ops")
    old = ShardingPropagator.__dict__[name]

    def flagged(self, *args, **kwargs):
        counter._propagating += 1
        try:
            return old(self, *args, **kwargs)
        finally:
            counter._propagating -= 1

    setattr(ShardingPropagator, name, flagged)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, old)


class Counter(TorchDispatchMode):
    """Counts the ops that reach it on plain (local) tensors: an op on
    DTensors is passed on (``NotImplemented``) to DTensor's dispatch, whose
    local ops and collectives then come back here. ``track(tree)`` starts
    the memory count with the arguments' storages."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.collectives = {k: 0.0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._propagating = 0
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry

    # -- memory ------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _see(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = int(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def track(self, tree) -> int:
        """Registers every tensor of ``tree`` (DTensors by their local
        shard); returns their storages' bytes."""
        before = self.live
        for t in _tensors(tree):
            self._see(t)
        return self.live - before

    def storage_keys(self, tree) -> Dict[int, int]:
        return {t.untyped_storage()._cdata: int(t.untyped_storage().nbytes())
                for t in _tensors(tree)}

    # -- dispatch ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating or func.namespace == "prim":
            return out
        self.ops += 1
        ins = [a for a in _flat(args) + _flat(kwargs)
               if isinstance(a, torch.Tensor)]
        outs = [o for o in _flat(out) if isinstance(o, torch.Tensor)]
        name = func.name()
        if "c10d_functional" in name:
            if "wait_tensor" not in name:
                kind = next((k for c, k in _C10D_KIND if c in name), None)
                if kind is not None:
                    self.collectives[kind] += sum(_nbytes(a) for a in ins)
        else:
            packet = func.overloadpacket
            if packet in self._flop_fns:
                self.flops += float(self._flop_fns[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += sum(_nbytes(a) for a in ins + outs)
        for o in outs:
            self._see(o)
        return out


def _flat(x) -> list:
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ----------------------------------------------------------------------
# per-cell dry-run
# ----------------------------------------------------------------------

def platform_for(mesh) -> Platform:
    """The mapping target of a production mesh's shape (the mapper's TPU
    pod platforms, JAX's)."""
    axes = tuple((name, size) for name, size in
                 zip(mesh.axis_names, mesh.devices.shape))
    if len(axes) == 3:
        return Platform(name="tpu-v5e-2x256", mesh_axes=axes)
    return Platform(name="tpu-v5e-256", mesh_axes=axes)


def optimise_cell(arch: ArchConfig, shape: ShapeSpec, platform: Platform,
                  *, backend: str = "spmd", objective: str = "latency",
                  zero1: bool = True, time_budget_s: float = 60.0,
                  overrides: Optional[Dict[str, Any]] = None, device=None):
    """SAMO end-to-end for one cell -> (plan, problem, result), the
    rule-based search on the port's torch engine on ``device`` (the card
    unless ``"cpu"`` is asked)."""
    graph = build_hdgraph(arch, shape)
    opts = ModelOptions(zero1=zero1, **(overrides or {}))
    problem = Problem(graph=graph, platform=platform,
                      backend=BACKENDS[backend], objective=objective,
                      exec_model="spmd", opts=opts)
    result = rule_based(problem, time_budget_s=time_budget_s,
                        device=resolve_device(device))
    plan = export_plan(graph, result.variables, platform, "spmd",
                       result.evaluation)
    return plan, problem, result


def _partition_signature(plan, model_arch: ArchConfig, pi: int) -> Tuple:
    part = plan.partitions[pi]
    kinds = tuple(sorted((k, kp.s_in, kp.s_out, kp.kern)
                         for k, kp in part.kinds.items()))
    n_layers = part.layer_end - part.layer_start
    pattern = tuple(model_arch.layer_kind(i) + ":" + model_arch.ffn_kind(i)
                    for i in range(part.layer_start, part.layer_end))
    return (part.has_embed, part.has_head, part.has_final_norm,
            n_layers, pattern[:4], pattern[-4:] if pattern else (),
            part.enc_end - part.enc_start, kinds)


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
                zero1: bool = True, time_budget_s: float = 60.0,
                overrides: Optional[Dict[str, Any]] = None,
                verbose: bool = True, device=None) -> Dict[str, Any]:
    """One cell's record. ``device``: where the plan is searched and what
    the fake tensors claim to be (the card unless ``"cpu"`` is asked)."""
    arch = get_arch(arch_name)
    shape = SHAPES_BY_NAME[shape_name]
    if not shape_applicable(arch, shape):
        return {"arch": arch_name, "shape": shape_name, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}

    device = resolve_device(device)
    mesh = make_fake_mesh(multi_pod=multi_pod, device=device)
    platform = platform_for(mesh)
    chips = platform.chips

    t0 = time.time()
    launched = segred.LAUNCHES
    plan, problem, result = optimise_cell(
        arch, shape, platform, zero1=zero1, time_budget_s=time_budget_s,
        overrides=overrides, device=device)
    opt_s = time.time() - t0

    record: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name,
        "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "chips": chips,
        "mode": shape.mode,
        "partitions": len(plan.partitions),
        "torch": torch.__version__,
        "samo": {
            "optimise_seconds": round(opt_s, 2),
            "objective": result.evaluation.objective,
            "latency_s": result.evaluation.latency,
            "throughput": result.evaluation.throughput,
            "feasible": result.evaluation.feasible,
            "reconf_s": result.evaluation.reconf_time,
            "points": result.points,
            "device": str(device),
            "segred_launches": segred.LAUNCHES - launched,
        },
        "cells": [],
    }

    # analytic (SAMO model) roofline terms, aggregated over the graph
    evals = result.evaluation.node_evals
    record["samo"]["model_terms"] = {
        "compute_s": sum(e.compute_s for e in evals),
        "memory_s": sum(e.memory_s for e in evals),
        "collective_s": sum(e.collective_s for e in evals),
    }

    # build and count each unique partition signature
    seen: Dict[Tuple, int] = {}
    for pi, part in enumerate(plan.partitions):
        sig = _partition_signature(plan, arch, pi)
        if sig in seen:
            record["cells"].append({"partition": pi, "same_as": seen[sig]})
            continue
        seen[sig] = pi
        cell = _compile_partition(arch, shape, plan, mesh, pi,
                                  zero1=zero1,
                                  seq_parallel=bool((overrides or {}).get(
                                      "seq_parallel_stash")),
                                  verbose=verbose)
        cell["partition"] = pi
        record["cells"].append(cell)

    # aggregate roofline over ALL partitions (duplicates scaled in)
    agg = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
           "peak_memory_gib": 0.0}
    by_pi = {c["partition"]: c for c in record["cells"] if "same_as" not in c}
    for c in record["cells"]:
        src = by_pi[c.get("same_as", c["partition"])]
        if "error" in src:
            continue
        agg["flops"] += src["flops"]
        agg["bytes"] += src["bytes"]
        agg["collective_bytes"] += src["collective_bytes"]
        agg["peak_memory_gib"] = max(agg["peak_memory_gib"],
                                     src["peak_memory_gib"])
    record["aggregate"] = agg
    record["roofline"] = roofline_terms(agg, chips, shape, arch)
    if mesh.device_mesh.device_type == "cpu":
        record["collectives_note"] = (
            "counted on a CPU mesh: DTensor moves a shard from one tensor "
            "dimension to another by an all-gather and a chunk there (its "
            "CPU fallback for all-to-all), so such moves count as "
            "all-gather")
    return record


def _period(arch: ArchConfig) -> int:
    """Smallest repeating layer-pattern period."""
    p = max(arch.attn_period, 1)
    if arch.is_moe and arch.moe_period > 1:
        q = arch.moe_period
        while p % q:
            p += max(arch.attn_period, 1)
    return p


def _fake(like: torch.Tensor, device) -> torch.Tensor:
    """A zero tensor of ``like``'s shape and dtype on ``device`` (fake
    under the dry run's mode)."""
    return torch.zeros(like.shape, dtype=like.dtype, device=device)


def build_partition(arch: ArchConfig, shape: ShapeSpec, plan, mesh, pi, *,
                    zero1: bool, seq_parallel: bool = False,
                    layer_range=None, include_embed: bool = True,
                    include_head: bool = True,
                    streaming: Optional[bool] = None):
    """The partition's step and its arguments, as JAX's ``_lower_one``
    builds them (train: parameters and optimiser state donated; serve:
    the cache), the arguments laid out as the step takes them. Run it
    under ``FakeTensorMode`` for the dry run, or on real tensors.
    ``streaming`` picks the weight-streaming partition step (default:
    where the plan has several partitions) over the full-graph step
    (``train()``'s). Returns (step, args, model): the model holds the
    parameters, which the step updates in place."""
    device = mesh.devices.flat[0]
    model = Model(arch, layer_range=layer_range, include_embed=include_embed,
                  include_head=include_head, attn_impl="chunked",
                  remat=shape.mode == "train", device=device)
    B = shape.global_batch
    S = shape.seq_len if shape.mode != "decode" else 1
    batch_sds = {k: _fake(v, device) for k, v in
                 input_specs(arch, shape).items()}
    multi = len(plan.partitions) > 1 if streaming is None else streaming
    act = torch.zeros((B, S, arch.d_model), dtype=torch.bfloat16,
                      device=device)

    if shape.mode == "train":
        dp_axes = plan.dp_axes(pi) or ("data",)
        kw = dict(zero1=zero1, seq_parallel=seq_parallel, dp_axes=dp_axes)
        if not multi:
            step = make_train_step(model, plan, mesh, pi,
                                   batch_keys=tuple(batch_sds), **kw)
            inputs = (batch_sds,)
        else:
            fwd_batch = {k: v for k, v in batch_sds.items() if k != "labels"}
            step = make_partition_train_step(model, plan, mesh, pi,
                                             batch_keys=tuple(fwd_batch),
                                             **kw)
            part = plan.partitions[pi]
            if part.has_head:
                inputs = (act, torch.zeros((B, S), dtype=torch.int32,
                                           device=device))
            elif part.has_embed:
                inputs = (fwd_batch, act)
            else:
                inputs = (act, torch.zeros_like(act))
        state = adamw_init(dict(model.named_parameters()))
        args = (step.layout.put_state(state) if step.layout else state,) \
            + tuple(_put_inputs(step, inputs, plan, pi))
    else:
        mode = "prefill" if shape.mode == "prefill" else "decode"
        max_len = shape.seq_len
        cache = model.init_cache(B, max_len, device=device)
        if not multi:
            step = make_serve_step(model, plan, mesh, mode, max_len, pi,
                                   batch_keys=tuple(batch_sds))
            x3 = batch_sds
        else:
            step = make_partition_serve_step(model, plan, mesh, mode,
                                             max_len, pi,
                                             batch_keys=tuple(batch_sds))
            x3 = batch_sds if plan.partitions[pi].has_embed else act
        if step.layout is not None:
            cache = step.layout.put_cache(cache)
        args = (cache,) + tuple(_put_inputs(step, (x3,), plan, pi))
        if mode == "decode":
            args += (torch.zeros((), dtype=torch.int32, device=device),)
    return step, args, model


def _put_inputs(step, inputs, plan, pi):
    """The step's inputs laid out as it takes them: a batch from the
    batch specs, an activation from the act spec, labels from the data
    spec."""
    from repro_torch.core.partition_spec import place
    layout = step.layout
    for x in inputs:
        if layout is None:
            yield x
        elif isinstance(x, dict):
            yield layout.put_batch(x)
        elif x.ndim == 2:
            yield place(x, plan.data_spec(pi), layout.mesh)
        else:
            yield layout.put_act(x)


def count_step(step, args, model=None) -> Dict[str, Any]:
    """Runs ``step(*args)`` once under a ``Counter``: this rank's FLOPs,
    bytes, collective operand bytes by kind and peak memory (JAX's record
    fields). The arguments count ``model``'s parameters (which JAX passes
    and the port's module holds) and the outputs its updated ones, so
    that, as in JAX, what a step updates in place is an argument, an
    output and an alias (donated, counted once)."""
    counter = Counter()
    params = dict(model.named_parameters()) if model is not None else {}
    arg_bytes = counter.track((args, params))
    arg_keys = counter.storage_keys((args, params))
    with _propagation_marked(counter), counter:
        out = step(*args)
    out_keys = counter.storage_keys((out, params))
    alias = sum(n for k, n in out_keys.items() if k in arg_keys)
    output = sum(out_keys.values())
    peak = counter.peak
    del out
    coll = counter.collectives
    return {
        "flops": counter.flops, "bytes": counter.bytes,
        "collective_bytes": float(sum(coll.values())),
        "collectives": {k: v for k, v in coll.items() if v},
        "ops": counter.ops,
        "peak_memory_gib": peak / 2**30,
        "memory": {
            "temp_gib": max(peak - arg_bytes - output + alias, 0) / 2**30,
            "arguments_gib": arg_bytes / 2**30,
            "output_gib": output / 2**30,
            "alias_gib": alias / 2**30,
        },
    }


def _compile_partition(arch: ArchConfig, shape: ShapeSpec, plan, mesh, pi,
                       *, zero1: bool, seq_parallel: bool = False,
                       verbose: bool) -> Dict[str, Any]:
    """One partition's record: the step built and run once on fake
    tensors, every op counted (JAX's ``compile_seconds`` is the build
    here, ``cost_seconds`` the counted run); a failure is recorded, with
    its traceback, and the cell goes on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    part = plan.partitions[pi]
    multi = len(plan.partitions) > 1
    out: Dict[str, Any] = {
        "layers": [part.layer_start, part.layer_end],
        "has_embed": part.has_embed, "has_head": part.has_head,
    }
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, model = build_partition(
                arch, shape, plan, mesh, pi, zero1=zero1,
                seq_parallel=seq_parallel,
                layer_range=((part.layer_start, part.layer_end) if multi
                             else None),
                include_embed=part.has_embed or not multi,
                include_head=part.has_head or not multi)
            out["compile_seconds"] = round(time.time() - t0, 2)
            t1 = time.time()
            costs = count_step(step, args, model)
            del step, args, model
        out["cost_seconds"] = round(time.time() - t1, 2)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"    p{pi}: FAILED {out['error'][:200]}", flush=True)
        return out
    out.update(costs)
    out["scanned_costs"] = {k: out[k] for k in
                            ("flops", "bytes", "collective_bytes")}
    out["cost_method"] = "counted"
    hbm = plan.platform.hbm_bytes
    out["fits"] = {"hbm_gib": hbm / 2**30,
                   "ok": out["peak_memory_gib"] * 2**30 <= hbm}
    if verbose:
        print(f"    p{pi}: built {out['compile_seconds']}s "
              f"(+{out['cost_seconds']}s counted, {out['ops']} ops) "
              f"peak={out['peak_memory_gib']:.2f}GiB "
              f"flops={out['flops']:.3e} coll={out['collective_bytes']:.3e}B",
              flush=True)
    return out


def roofline_terms(agg: Dict[str, float], chips: int, shape: ShapeSpec,
                   arch: ArchConfig, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, Any]:
    """The three roofline terms of one device (the counts are per device)
    against ``peak_flops``, ``hbm_bw`` and ``link_bw`` (default: the H100
    SXM's, ``CARD``)."""
    compute_s = agg["flops"] / peak_flops
    memory_s = agg["bytes"] / hbm_bw
    collective_s = agg["collective_bytes"] / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)

    # MODEL_FLOPS: 6 N D for training, 2 N D for inference (N = active params)
    n_active = arch.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    model_flops = mult * n_active * tokens
    hlo_total = agg["flops"] * chips
    return {
        **terms,
        "bottleneck": dom.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_total": hlo_total,
        "useful_fraction": model_flops / hlo_total if hlo_total else 0.0,
        "step_time_bound_s": max(terms.values()),
    }


# ----------------------------------------------------------------------
# command line
# ----------------------------------------------------------------------

def all_cell_names():
    for arch in ARCHS.values():
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = SHAPES_BY_NAME[sname]
            if shape_applicable(arch, shape):
                yield arch.name, sname


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--time-budget", type=float, default=60.0)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="where the plan is searched and what the fake "
                         "tensors claim to be (default: the card; 'cpu' "
                         "asks for the CPU)")
    args = ap.parse_args(argv)
    # DTensor warns of each two-step redistribution on the 2-D mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    os.makedirs(args.out, exist_ok=True)
    cells: List[Tuple[str, str]] = []
    if args.all:
        cells = list(all_cell_names())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = 0
    # single-pod pass first (it carries the roofline table), then multi-pod
    for mp in meshes:
        for arch_name, shape_name in cells:
            tag = "2pod" if mp else "1pod"
            print(f"== {arch_name} x {shape_name} [{tag}] ==", flush=True)
            t0 = time.time()
            rec = dryrun_cell(arch_name, shape_name, multi_pod=mp,
                              zero1=not args.no_zero1,
                              time_budget_s=args.time_budget,
                              device=args.device)
            rec["host_seconds"] = round(time.time() - t0, 2)
            path = os.path.join(args.out,
                                f"{arch_name}__{shape_name}__{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            bad = [c for c in rec.get("cells", []) if "error" in c]
            if bad:
                failures += 1
                print(f"  !! {len(bad)} partition(s) failed", flush=True)
            elif rec.get("skipped"):
                print(f"  skipped: {rec['reason']}", flush=True)
            else:
                rl = rec["roofline"]
                print(f"  ok: parts={rec['partitions']} "
                      f"bottleneck={rl['bottleneck']} "
                      f"bound={rl['step_time_bound_s']:.3f}s "
                      f"useful={rl['useful_fraction']:.2f} "
                      f"({rec['host_seconds']} s)", flush=True)
    return 1 if failures else 0


__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "Counter",
           "platform_for", "optimise_cell", "dryrun_cell", "build_partition",
           "count_step", "roofline_terms", "all_cell_names", "main"]


if __name__ == "__main__":
    sys.exit(main())
