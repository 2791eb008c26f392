"""Exporter: optimised HD-Graph -> ShardingPlan (paper §IV-E).

The paper's exporter writes the optimised folding factors back into the
backend's customised IR; ours legalises V = {C, s^I, s^O, k} onto the physical
mesh and emits a ``ShardingPlan`` — per-partition, per-node-kind mesh-axis
assignments — which is what ``launch/{dryrun,train,serve}.py`` and the model
zoo consume, plus ``PartitionSpec`` constructors (the port's own,
``core/partition_spec.py``).

Axis-assignment preference: batch folds take ("pod","data"), row folds take
"data", col folds take "model"; conflicts fall back to any disjoint
assignment (the folds were already validated mesh-realisable).

Param-sharding roles (shared vocabulary with models/*):
  col        weight matrix whose OUTPUT dim is the folded channel dim
             (q/k/v/gate/up projections) -> shard last dim on cols_axes
  row        weight matrix whose INPUT dim is the folded channel dim
             (out/down projections)      -> shard second-to-last dim
  expert     leading experts dim         -> shard dim 0 (after stack dims)
  table      embedding table (V, D)      -> shard dim 0 on cols_axes
  head       LM head (D, V)              -> shard last dim on cols_axes
  replicate  norms, scalars, biases
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hdgraph import HDGraph, Variables, partitions_from_cuts
from repro_torch.core.partition_spec import PartitionSpec
from repro_torch.core.platform import Platform


def _pspec():
    """The ``PartitionSpec`` constructor of the spec-emitting methods below:
    the port's own (a tuple of entries, as JAX's compares), which needs no
    jax."""
    return PartitionSpec


@dataclass(frozen=True)
class KindPlan:
    kind: str
    s_in: int
    s_out: int
    kern: int
    rows_axes: Tuple[str, ...]
    cols_axes: Tuple[str, ...]
    batch_axes: Tuple[str, ...]


@dataclass
class PartitionPlan:
    index: int
    node_indices: List[int]
    kinds: Dict[str, KindPlan]
    layer_start: int = 0            # decoder layers covered [start, end)
    layer_end: int = 0
    has_embed: bool = False
    has_head: bool = False
    has_final_norm: bool = False
    enc_start: int = 0
    enc_end: int = 0


@dataclass
class ShardingPlan:
    arch_name: str
    shape_name: str
    mode: str
    exec_model: str
    platform: Platform
    partitions: List[PartitionPlan]
    objective_value: float = 0.0
    throughput: float = 0.0
    latency: float = 0.0

    # ------------------------------------------------------------------
    def kind_plan(self, kind: str, partition: int = 0) -> KindPlan:
        part = self.partitions[partition]
        if kind in part.kinds:
            return part.kinds[kind]
        # default: replicated compute, batch over all batch-capable axes
        return KindPlan(kind, 1, 1, 1, (), (), ())

    def data_spec(self, partition: int = 0):
        """PartitionSpec for (batch, seq) token inputs."""
        P = _pspec()
        kp = self._boundary_kind(partition)
        return P(_axes(kp.batch_axes), _axes(kp.rows_axes))

    def act_spec(self, partition: int = 0):
        """PartitionSpec for (batch, seq, d_model) activations. Decode
        activations are one token wide — their rows dim cannot shard."""
        P = _pspec()
        kp = self._boundary_kind(partition)
        rows = None if self.mode == "decode" else _axes(kp.rows_axes)
        return P(_axes(kp.batch_axes), rows, None)

    def _boundary_kind(self, partition: int) -> KindPlan:
        part = self.partitions[partition]
        for kind in ("attn", "ssm", "rwkv_tmix", "ffn", "moe", "enc_attn"):
            if kind in part.kinds:
                return part.kinds[kind]
        return KindPlan("none", 1, 1, 1, (), (), ())

    def dp_axes(self, partition: int = 0) -> Tuple[str, ...]:
        """Mesh axes carrying data parallelism at this partition's boundary
        (ZeRO-1 shards optimiser state over these)."""
        return self._boundary_kind(partition).batch_axes

    def spec_for_role(self, role: str, ndim: int, kind: str,
                      partition: int = 0, stacked: int = 0):
        """PartitionSpec for a parameter with `stacked` leading scan dims."""
        P = _pspec()
        kp = self.kind_plan(kind, partition)
        cols = _axes(kp.cols_axes)
        lead = [None] * stacked
        body = ndim - stacked
        if role == "replicate" or cols is None:
            return P(*([None] * ndim))
        if role == "col":
            return P(*lead, *([None] * (body - 1)), cols)
        if role == "row":
            return P(*lead, *([None] * (body - 2)), cols, None)
        if role == "expert":
            return P(*lead, cols, *([None] * (body - 1)))
        if role == "table":
            return P(cols, *([None] * (ndim - 1)))
        if role == "head":
            return P(*([None] * (ndim - 1)), cols)
        raise ValueError(role)

    def kv_cache_spec(self, partition: int = 0):
        """(batch, kv_len, kv_heads, head_dim) cache spec: batch over k axes,
        length over rows axes (split-KV), heads over cols axes (up to the
        GQA limit — legalisation already clamped)."""
        P = _pspec()
        kp = self.kind_plan("attn", partition)
        return P(_axes(kp.batch_axes), _axes(kp.rows_axes),
                 _axes(kp.cols_axes), None)


def _axes(axes: Tuple[str, ...]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ----------------------------------------------------------------------
# legalisation: fold triples -> disjoint mesh-axis subsets with preference
# ----------------------------------------------------------------------

_PREF = {
    "batch": ("pod", "data", "model"),
    "rows": ("data", "pod", "model"),
    "cols": ("model", "data", "pod"),
}


def _assign(platform: Platform, kern: int, s_in: int, s_out: int
            ) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]]:
    """(batch_axes, rows_axes, cols_axes) — preference-ordered search."""
    table = platform.realizable_folds()

    def options(fold: int, pref: Tuple[str, ...]):
        subs = table.get(fold, [])
        return sorted(subs, key=lambda s: tuple(pref.index(a) if a in pref
                                                else 99 for a in sorted(s)))

    for b in options(kern, _PREF["batch"]):
        for r in options(s_in, _PREF["rows"]):
            if r & b:
                continue
            for c in options(s_out, _PREF["cols"]):
                if c & (b | r):
                    continue
                order = {n: i for i, (n, _) in enumerate(platform.mesh_axes)}
                return (tuple(sorted(b, key=order.get)),
                        tuple(sorted(r, key=order.get)),
                        tuple(sorted(c, key=order.get)))
    return None


def export_plan(graph: HDGraph, variables: Variables, platform: Platform,
                exec_model: str = "spmd",
                evaluation=None) -> ShardingPlan:
    parts = partitions_from_cuts(graph, variables.cuts)
    partition_plans: List[PartitionPlan] = []
    for pi, part in enumerate(parts):
        kinds: Dict[str, KindPlan] = {}
        pp = PartitionPlan(index=pi, node_indices=list(part), kinds=kinds)
        dec_layers, enc_layers = [], []
        for i in part:
            n = graph.nodes[i]
            if n.kind == "embed":
                pp.has_embed = True
            elif n.kind == "head":
                pp.has_head = True
            elif n.kind == "norm":
                pp.has_final_norm = True
            elif n.kind in ("enc_attn", "enc_ffn"):
                enc_layers.append(n.layer)
            else:
                dec_layers.append(n.layer)
            if n.kind in kinds:
                continue
            si, so, k = variables.s_in[i], variables.s_out[i], variables.kern[i]
            assign = _assign(platform, k, si, so)
            if assign is None:
                # legalisation fallback: drop the row fold first, then cols
                for si2, so2, k2 in ((1, so, k), (si, so, 1), (1, so, 1),
                                     (1, 1, k), (1, 1, 1)):
                    assign = _assign(platform, k2, si2, so2)
                    if assign is not None:
                        si, so, k = si2, so2, k2
                        break
            b, r, c = assign
            kinds[n.kind] = KindPlan(n.kind, si, so, k, r, c, b)
        if dec_layers:
            pp.layer_start, pp.layer_end = min(dec_layers), max(dec_layers) + 1
        if enc_layers:
            pp.enc_start, pp.enc_end = min(enc_layers), max(enc_layers) + 1
        partition_plans.append(pp)

    plan = ShardingPlan(
        arch_name=graph.arch_name,
        shape_name=graph.shape_name,
        mode=graph.mode,
        exec_model=exec_model,
        platform=platform,
        partitions=partition_plans,
    )
    if evaluation is not None:
        plan.objective_value = evaluation.objective
        plan.throughput = evaluation.throughput
        plan.latency = evaluation.latency
    return plan


def default_plan(graph: HDGraph, platform: Platform,
                 backend=None, exec_model: str = "spmd") -> ShardingPlan:
    """The unoptimised baseline plan the paper's Table V calls *init.*:
    a single partition, pure data parallelism over all batch-capable axes
    (folds otherwise 1)."""
    from repro_torch.core.backends import SIMPLE
    backend = backend or SIMPLE
    v = backend.initial(graph).with_cuts(())
    # raise k as far as the batch divides
    kmax = 1
    for f in sorted(platform.fold_values()):
        if all(n.batch % f == 0 for n in graph.nodes):
            kmax = f
    v = backend.set_fold(graph, v, 0, "kern", kmax)
    return export_plan(graph, v, platform, exec_model)
