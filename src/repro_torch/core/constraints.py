"""Optimisation constraints (paper §III-E, Eq. 6-10).

  resource        Eq. 6  — per-partition HBM residency and, under the
                           streaming execution model, the spatial chip budget
                           (sum of per-node chip groups <= mesh chips).
  bandwidth       Eq. 7  — partition boundary featuremaps must stream through
                           host<->HBM DMA faster than the partition interval.
  channel factor  Eq. 8  — folds divide their dims AND are mesh-realisable
                           (products of disjoint mesh-axis subsets).
  intra matching  Eq. 9  — elementwise nodes keep s_I == s_O.
  inter matching  Eq. 10 — adjacent nodes agree on the activation layout
                           (s_I and k); backends without this constraint pay a
                           modelled resharding collective instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from repro_torch.core.hdgraph import HDGraph, Variables, boundary_bytes, partitions_from_cuts
from repro_torch.core.perfmodel import ModelOptions, NodeEval, eval_nodes, partition_time
from repro_torch.core.platform import Platform


@dataclass
class ConstraintReport:
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, msg: str) -> None:
        self.violations.append(msg)


def check_all(graph: HDGraph, v: Variables, platform: Platform,
              evals: List[NodeEval], exec_model: str, backend,
              rep: ConstraintReport) -> ConstraintReport:
    """Run the backend's full constraint chain (Eq. 6-10) into ``rep``.

    Single source of truth for which checks a backend enables — shared by
    ``Problem.check``/``Problem.evaluate`` and mirrored (as boolean masks) by
    ``core/batched_eval.py``.
    """
    check_channel_factor(graph, v, platform, rep,
                         strict_kv=backend.strict_kv)
    if backend.intra_matching:
        check_intra_matching(graph, v, rep)
    if backend.inter_matching:
        check_inter_matching(graph, v, rep)
    if backend.scan_tying:
        check_scan_tying(graph, v, rep)
    check_resource(graph, v, platform, evals, exec_model, rep)
    check_bandwidth(graph, v, platform, evals, exec_model, rep)
    return rep


def check_channel_factor(graph: HDGraph, v: Variables, platform: Platform,
                         rep: ConstraintReport, strict_kv: bool = False) -> None:
    """Eq. 8 + TPU mesh-realisability + layer-aligned cuts."""
    allowed = set(graph.cut_edges)
    for c in v.cuts:
        if not (0 <= c < len(graph.nodes) - 1):
            rep.add(f"cut {c} out of range for "
                    f"{len(graph.nodes)}-node graph")
        elif c not in allowed:
            rep.add(f"cut {c} not on a layer boundary")
    for i, n in enumerate(graph.nodes):
        si, so, k = v.s_in[i], v.s_out[i], v.kern[i]
        if n.rows % si != 0:
            rep.add(f"{n.name}: s_I={si} does not divide rows={n.rows}")
        if n.col_div % so != 0:
            rep.add(f"{n.name}: s_O={so} does not divide cols={n.col_div}")
        if n.batch % k != 0:
            rep.add(f"{n.name}: k={k} does not divide batch={n.batch}")
        if strict_kv and n.kv_limit and so > n.kv_limit:
            rep.add(f"{n.name}: s_O={so} exceeds kv_heads={n.kv_limit} (strict)")
        if not platform.folds_realizable((si, so, k)):
            rep.add(f"{n.name}: folds ({si},{so},{k}) not mesh-realisable")


def check_intra_matching(graph: HDGraph, v: Variables,
                         rep: ConstraintReport) -> None:
    """Eq. 9."""
    for i, n in enumerate(graph.nodes):
        if n.elementwise and v.s_in[i] != v.s_out[i]:
            rep.add(f"{n.name}: elementwise node needs s_I == s_O "
                    f"({v.s_in[i]} != {v.s_out[i]})")


def check_inter_matching(graph: HDGraph, v: Variables,
                         rep: ConstraintReport) -> None:
    """Eq. 10 (activation-layout agreement between adjacent nodes).

    Applies only WITHIN a partition: across a cut, activations are staged
    through HBM and re-laid-out for free. Nodes whose rows dim is internal
    (decode split-KV attention) present a boundary row-fold of 1 regardless
    of s_I.
    """
    def b_in(i: int) -> int:
        return 1 if graph.nodes[i].internal_rows else v.s_in[i]

    cuts = set(v.cuts)
    for i in range(len(graph.nodes) - 1):
        if i in cuts:
            continue
        if b_in(i) != b_in(i + 1) or v.kern[i] != v.kern[i + 1]:
            a, b = graph.nodes[i], graph.nodes[i + 1]
            rep.add(f"{a.name}->{b.name}: layout mismatch "
                    f"(s_I {b_in(i)}!={b_in(i+1)} or k {v.kern[i]}!={v.kern[i+1]})")


def check_scan_tying(graph: HDGraph, v: Variables,
                     rep: ConstraintReport) -> None:
    """Nodes of one scan group within one partition share their folds
    (stacked lax.scan has a single sharding)."""
    parts = partitions_from_cuts(graph, v.cuts)
    for part in parts:
        seen = {}
        for i in part:
            g = graph.nodes[i].scan_group
            if g < 0:
                continue
            trip = (v.s_in[i], v.s_out[i], v.kern[i])
            if g in seen and seen[g] != trip:
                rep.add(f"scan group {g} folds differ within a partition: "
                        f"{seen[g]} vs {trip} at {graph.nodes[i].name}")
            seen.setdefault(g, trip)


def check_resource(graph: HDGraph, v: Variables, platform: Platform,
                   evals: List[NodeEval], exec_model: str,
                   rep: ConstraintReport) -> None:
    """Eq. 6 — per-partition HBM residency (incl. staged boundary featuremaps
    for multi-partition designs) and, under streaming, the spatial chip budget."""
    parts = partitions_from_cuts(graph, v.cuts)
    multi = len(parts) > 1
    bounds = boundary_bytes(graph, parts) if multi else None
    for pi, part in enumerate(parts):
        per_chip = sum(evals[i].hbm_resident for i in part)
        if multi:
            d_in, d_out = bounds[pi]
            # the whole batch's boundary activations persist across the
            # reconfiguration, sharded over all chips
            per_chip += (d_in + d_out) / platform.chips
        if per_chip > platform.hbm_bytes:
            rep.add(f"partition {pi}: HBM residency {per_chip/2**30:.1f} GiB "
                    f"> {platform.hbm_bytes/2**30:.0f} GiB")
        if exec_model == "streaming":
            chips = sum(evals[i].chips for i in part)
            if chips > platform.chips:
                rep.add(f"partition {pi}: spatial chips {chips} > {platform.chips}")


def check_bandwidth(graph: HDGraph, v: Variables, platform: Platform,
                    evals: List[NodeEval], exec_model: str,
                    rep: ConstraintReport) -> None:
    """Eq. 7 — boundary featuremaps stream through per-chip HBM while the
    partition executes (on TPU the staging store is HBM, not off-chip DRAM;
    see DESIGN.md §2). Binds only for multi-partition designs."""
    parts = partitions_from_cuts(graph, v.cuts)
    if len(parts) == 1:
        return
    bw = platform.hbm_bw * platform.chips
    for pi, (part, (d_in, d_out)) in enumerate(zip(parts, boundary_bytes(graph, parts))):
        t = partition_time(graph, part, evals, exec_model)
        if t <= 0:
            continue
        if (d_in + d_out) / t > bw:
            rep.add(f"partition {pi}: boundary bandwidth "
                    f"{(d_in+d_out)/t/1e9:.1f} GB/s > platform {bw/1e9:.1f} GB/s")
