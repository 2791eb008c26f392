"""Hardware Description Graph (paper §III-A) and partitioning (§III-B, Eq. 1).

A ``Node`` is one parameterised hardware building block: on TPU, one
transformer-op instance (attention layer, FFN/MoE layer, SSM mixer, embedding,
LM head, ...). Each node carries the *base* workload quantities from which the
backend performance/resource models (core/perfmodel.py) derive
``t(n | s_I, s_O, k)`` and ``r(n | s_I, s_O, k)``.

Folding-variable semantics on TPU (our Table-I analogue):
  s_I  — input-featuremap (row/sequence) folding: context/sequence parallelism;
         for decode nodes it folds the KV/state length (split-KV).
  s_O  — output-channel folding: tensor parallelism over heads / d_ff /
         experts / vocab.
  k    — kernel folding: data parallelism over the batch dim.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Node:
    name: str
    kind: str                 # embed|attn|cross_attn|ffn|moe|ssm|rwkv_tmix|rwkv_cmix|norm|head
    layer: int                # layer index (-1 for embed/head/final norm)
    # Foldable dimensions.
    rows: int                 # sequence rows entering the node (or KV len in decode)
    cols: int                 # output-channel dim (heads, d_ff, experts, vocab, d_model)
    batch: int                # global batch
    # Base workload (unfolded totals, forward pass unless noted).
    flops: float              # total FLOPs for the node at the given shape/mode
    weight_bytes: float       # parameter bytes (dtype applied)
    act_bytes: float          # boundary featuremap HBM traffic: folds by (k, s_I)
    inner_bytes: float = 0.0  # intermediate traffic (d_ff/head space): folds by (k, s_I, s_O)
    state_bytes: float = 0.0  # persistent per-batch state (KV cache, SSM state)
    # Constraint metadata.
    elementwise: bool = False     # Eq. 9 intra-folding matching applies
    kv_bytes: float = 0.0         # full K+V bytes (attention): ring-exchange
                                  # traffic when rows are folded (seq parallel)
    carry_bytes: float = 0.0      # recurrent chunk-boundary state (SSM/RWKV):
                                  # passed between row-fold neighbours
    col_divisor: int = 0          # cols fold must divide this (0 => cols itself)
    kv_limit: int = 0             # GQA: folds beyond this replicate KV (spmd only)
    ep_topk: int = 0              # MoE: experts per token (all-to-all fan-out)
    weight_stream: bool = False   # weights re-read from HBM every step (inference)
    internal_rows: bool = False   # rows dim is node-internal (decode split-KV):
                                  # boundary layout fold is 1, not s_I
    scan_group: int = -1          # nodes sharing a scan-group tie their folds
    collective_kind: str = "none" # none|tp_allreduce|ep_alltoall|vocab_allreduce
    train_multiplier: float = 1.0 # 3.0 when backward pass included
    fm_width: int = 0             # featuremap channel width at the node boundary (d_model)

    @property
    def col_div(self) -> int:
        return self.col_divisor or self.cols


@dataclass
class HDGraph:
    """Sequential HD-Graph: nodes + implicit chain edges (paper §III-A)."""

    nodes: List[Node]
    arch_name: str = ""
    shape_name: str = ""
    mode: str = "train"            # train | prefill | decode

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)

    @property
    def edges(self) -> List[Tuple[int, int]]:
        return [(i, i + 1) for i in range(len(self.nodes) - 1)]

    @property
    def cut_edges(self) -> Tuple[int, ...]:
        """Edges where a partition cut is allowed: layer boundaries only.

        A cut inside a layer (between its mixer and its FFN) would make the
        exported partitions overlap at layer granularity — the compiled
        per-partition programs execute whole layers. The FPGA paper cuts at
        arbitrary edges; constraining to layer boundaries is the TPU
        execution-model adaptation (recorded in DESIGN.md)."""
        out = []
        for e in range(len(self.nodes) - 1):
            a, b = self.nodes[e], self.nodes[e + 1]
            if a.layer != b.layer or a.kind == "embed":
                out.append(e)
        return tuple(out)

    def scan_groups(self) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i, n in enumerate(self.nodes):
            if n.scan_group >= 0:
                groups.setdefault(n.scan_group, []).append(i)
        return groups


def partitions_from_cuts(graph: HDGraph, cuts: Sequence[int]) -> List[List[int]]:
    """Eq. 1: cut positions -> disjoint, complete list of node-index blocks.

    A cut at edge ``e`` separates node ``e`` from node ``e+1``. ``cuts`` is a
    sorted sequence of edge indices in [0, N-2]; |C|=0 returns the whole graph.
    """
    n = len(graph.nodes)
    cuts = list(cuts)
    if len(set(cuts)) != len(cuts):
        # a duplicate cut is always a caller bug (it would silently
        # collapse into one cut and mis-count |C| in Eq. 3) — refuse it
        # instead of deduplicating; ``Variables.with_cuts`` is the
        # canonicalising entry point for callers with raw cut sets
        raise ValueError(f"duplicate cut indices in {tuple(cuts)}")
    cuts = sorted(cuts)
    for c in cuts:
        if not (0 <= c < n - 1):
            raise ValueError(f"cut {c} out of range for {n}-node graph")
    bounds = [0] + [c + 1 for c in cuts] + [n]
    parts = [list(range(bounds[i], bounds[i + 1])) for i in range(len(bounds) - 1)]
    # disjoint + complete by construction (paper: ∩P=∅, ∪P=H)
    return parts


def boundary_bytes(graph: HDGraph, parts: List[List[int]]) -> List[Tuple[float, float]]:
    """(D_in, D_out) featuremap bytes crossing each partition boundary (Eq. 7).

    Between partitions the whole batch's activations are staged through
    host/HBM, so each partition streams its input featuremap in and its output
    featuremap out.
    """
    out = []
    for p in parts:
        first, last = graph.nodes[p[0]], graph.nodes[p[-1]]
        # Activation featuremap entering/leaving, bf16: (batch, rows, fm_width).
        d_in = first.batch * first.rows * first.fm_width * 2.0
        d_out = last.batch * last.rows * last.fm_width * 2.0
        out.append((d_in, d_out))
    return out


@dataclass(frozen=True)
class Variables:
    """The optimisation variables V = {C, s^I, s^O, k} (paper §III-C/D)."""

    cuts: Tuple[int, ...]
    s_in: Tuple[int, ...]
    s_out: Tuple[int, ...]
    kern: Tuple[int, ...]

    def __post_init__(self):
        # Degenerate cut vectors (duplicates, unsorted, negative) used to
        # pass silently into ``partitions_from_cuts`` and corrupt the
        # |C| accounting; reject them at construction with a clear error.
        # Range against the graph length is checked where a graph is in
        # scope (``check_channel_factor`` / ``partitions_from_cuts``).
        for a, b in zip(self.cuts, self.cuts[1:]):
            if a >= b:
                raise ValueError(
                    f"cuts must be strictly increasing, got {self.cuts} "
                    f"(use with_cuts() to canonicalise a raw cut set)")
        if self.cuts and self.cuts[0] < 0:
            raise ValueError(f"negative cut index in {self.cuts}")
        if not (len(self.s_in) == len(self.s_out) == len(self.kern)):
            raise ValueError(
                f"fold vectors must have equal length, got "
                f"|s_in|={len(self.s_in)} |s_out|={len(self.s_out)} "
                f"|kern|={len(self.kern)}")

    def replace_node(self, i: int, s_in=None, s_out=None, kern=None) -> "Variables":
        si, so, kk = list(self.s_in), list(self.s_out), list(self.kern)
        if s_in is not None:
            si[i] = s_in
        if s_out is not None:
            so[i] = s_out
        if kern is not None:
            kk[i] = kern
        return Variables(self.cuts, tuple(si), tuple(so), tuple(kk))

    def with_cuts(self, cuts: Sequence[int]) -> "Variables":
        return Variables(tuple(sorted(set(cuts))), self.s_in, self.s_out, self.kern)

    @property
    def num_partitions(self) -> int:
        return len(self.cuts) + 1


def resource_minimal(graph: HDGraph) -> Variables:
    """The paper's V_init: folds all 1 (fully sequential) and the HD-Graph
    split completely (a cut on every allowed edge)."""
    n = len(graph.nodes)
    ones = tuple([1] * n)
    return Variables(graph.cut_edges, ones, ones, ones)
