"""Backend integration (paper §IV-A, Tables I & II) — TPU edition.

Three lowering backends of decreasing design-space richness mirror the paper's
fpgaConvNet / FINN / HLS4ML triple:

  spmd      (≈fpgaConvNet)  all three folds free per scan group; adjacent
                            layout mismatches are ALLOWED and pay a modelled
                            resharding collective (inter matching ✗).
  megatron  (≈FINN)         s_O free per scan group; s_I and k are global
                            (SIMD-like tying); inter matching ✓ (no resharding
                            collectives may be inserted); strict KV channel
                            factor (s_O must divide kv_heads on attention).
  simple    (≈HLS4ML)       one global reuse factor: pure data parallelism
                            (k global, s_I = s_O = 1). intra matching ✗.

Each backend provides the candidate fold menus, mutation moves with the
paper's constraint propagation ("the change is propagated throughout the
whole HD-graph to fix intra/inter folding matching"), and the brute-force
enumeration space.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.hdgraph import HDGraph, Node, Variables, resource_minimal
from repro_torch.core.platform import Platform

VARS = ("s_in", "s_out", "kern")


def _divisors_from(values: Iterable[int], dim: int) -> List[int]:
    return sorted(v for v in values if v >= 1 and dim % v == 0)


@dataclass(frozen=True)
class Backend:
    name: str
    strict_kv: bool
    intra_matching: bool
    inter_matching: bool
    scan_tying: bool
    granularity: Dict[str, str]        # var -> node | group | global
    fixed_unity: Tuple[str, ...] = ()  # vars pinned to 1 (simple backend)

    # ------------------------------------------------------------------
    # candidate menus (channel-factor-legal, mesh-realisable fold values)
    # ------------------------------------------------------------------
    def candidates(self, graph: HDGraph, i: int, var: str,
                   platform: Platform) -> List[int]:
        node = graph.nodes[i]
        if var in self.fixed_unity:
            return [1]
        values = platform.fold_values()
        if var == "s_in":
            if self.granularity["s_in"] == "global":
                return self._global_row_candidates(graph, platform)
            return _divisors_from(values, node.rows)
        if var == "s_out":
            dim = node.col_div
            cands = _divisors_from(values, dim)
            if self.strict_kv and node.kv_limit:
                cands = [c for c in cands if c <= node.kv_limit
                         and node.kv_limit % c == 0]
            return cands or [1]
        if var == "kern":
            return _divisors_from(values, node.batch)
        raise ValueError(var)

    def _global_row_candidates(self, graph: HDGraph,
                               platform: Platform) -> List[int]:
        cands = set(platform.fold_values())
        for n in graph.nodes:
            if n.internal_rows:
                continue
            cands &= set(_divisors_from(platform.fold_values(), n.rows))
        return sorted(cands) or [1]

    # ------------------------------------------------------------------
    # scoped assignment with constraint propagation
    #
    # Scopes are PARTITION-LOCAL: each partition is its own compiled
    # program (its own "bitstream"), so variable tying and layout matching
    # never cross a cut — reconfigurability is exactly what frees them
    # (paper §III-B).
    # ------------------------------------------------------------------
    @staticmethod
    def _partition_of(graph: HDGraph, i: int,
                      cuts: Sequence[int]) -> range:
        lo, hi = 0, len(graph.nodes)
        for c in sorted(cuts):
            if c < i:
                lo = c + 1
            else:
                hi = min(hi, c + 1)
                break
        return range(lo, hi)

    def scope(self, graph: HDGraph, i: int, var: str,
              cuts: Sequence[int] = ()) -> List[int]:
        """Node indices that share this variable with node i."""
        g = self.granularity[var]
        part = self._partition_of(graph, i, cuts)
        if g == "global":
            return list(part)
        if g == "group" and graph.nodes[i].scan_group >= 0:
            sg = graph.nodes[i].scan_group
            return [j for j in part if graph.nodes[j].scan_group == sg]
        return [i]

    def set_fold(self, graph: HDGraph, v: Variables, i: int, var: str,
                 value: int) -> Variables:
        si, so, kk = list(v.s_in), list(v.s_out), list(v.kern)
        arrays = {"s_in": si, "s_out": so, "kern": kk}
        for j in self.scope(graph, i, var, v.cuts):
            node = graph.nodes[j]
            val = value
            # clamp to a legal divisor for this node (propagation keeps V valid)
            dim = {"s_in": node.rows, "s_out": node.col_div,
                   "kern": node.batch}[var]
            while val > 1 and dim % val != 0:
                val -= 1
            if var == "s_in" and node.internal_rows and \
                    self.granularity["s_in"] == "global":
                continue                     # decode split-KV keeps its own s_I
            arrays[var][j] = val
        out = Variables(v.cuts, tuple(si), tuple(so), tuple(kk))
        return self.propagate(graph, out)

    def propagate(self, graph: HDGraph, v: Variables) -> Variables:
        """Fix intra (Eq. 9) and inter (Eq. 10) matching after a change.

        Matching is partition-local: across a cut, the featuremap is staged
        through HBM, so no layout agreement is required (the paper's data
        lines only wire blocks within one configuration)."""
        si, so, kk = list(v.s_in), list(v.s_out), list(v.kern)
        n_nodes = len(graph.nodes)
        if self.scan_tying:
            # harmonise scan-group folds within each partition (one stacked
            # lax.scan has a single sharding): first member's triple wins.
            bounds0 = [0] + [c + 1 for c in sorted(v.cuts)] + [n_nodes]
            for b in range(len(bounds0) - 1):
                anchors = {}
                for j in range(bounds0[b], bounds0[b + 1]):
                    g = graph.nodes[j].scan_group
                    if g < 0:
                        continue
                    if g not in anchors:
                        anchors[g] = (si[j], so[j], kk[j])
                    else:
                        si[j], so[j], kk[j] = anchors[g]
        if self.intra_matching:
            for j, n in enumerate(graph.nodes):
                if n.elementwise:
                    so[j] = si[j]
        if self.inter_matching:
            # chain equality on boundary layout => per-partition (s_I, k);
            # anchored at the partition's first non-internal node.
            bounds = [0] + [c + 1 for c in sorted(v.cuts)] + [n_nodes]
            for b in range(len(bounds) - 1):
                part = range(bounds[b], bounds[b + 1])
                anchor_si = next((si[j] for j in part
                                  if not graph.nodes[j].internal_rows), 1)
                anchor_k = kk[part[0]]
                for j in part:
                    n = graph.nodes[j]
                    kk[j] = anchor_k if n.batch % anchor_k == 0 else 1
                    if not n.internal_rows:
                        si[j] = anchor_si if n.rows % anchor_si == 0 else 1
                    if n.elementwise and self.intra_matching:
                        so[j] = si[j]
        return Variables(v.cuts, tuple(si), tuple(so), tuple(kk))

    def initial(self, graph: HDGraph) -> Variables:
        return self.propagate(graph, resource_minimal(graph))

    # ------------------------------------------------------------------
    # SA random transformation (paper Algorithm 1, line 5)
    # ------------------------------------------------------------------
    def random_move(self, rng: random.Random, graph: HDGraph, v: Variables,
                    platform: Platform, allow_cuts: bool = True) -> Variables:
        n = len(graph.nodes)
        r = rng.random()
        if allow_cuts and r < 0.25:
            cuts = set(v.cuts)
            move = rng.random()
            all_edges = set(graph.cut_edges)
            if move < 0.45 and cuts:
                cuts.remove(rng.choice(sorted(cuts)))          # merge
            elif move < 0.9 and (all_edges - cuts):
                cuts.add(rng.choice(sorted(all_edges - cuts)))  # split
            elif cuts and (all_edges - cuts):
                cuts.remove(rng.choice(sorted(cuts)))
                cuts.add(rng.choice(sorted(all_edges - cuts)))  # move
            return v.with_cuts(sorted(cuts))
        i = rng.randrange(n)
        if r < 0.60:
            # joint re-draw of the node's whole fold triple. TPU adaptation:
            # mesh-realisable fold menus are far coarser than FPGA integer
            # folds, so single-variable moves cannot cross the valleys between
            # e.g. TP-heavy (16,16,1) and DP-heavy (1,1,256) states.
            menus = {var: self.candidates(graph, i, var, platform)
                     for var in VARS}
            for _ in range(8):
                triple = {var: rng.choice(menus[var]) for var in VARS}
                if platform.folds_realizable(tuple(triple.values())):
                    break
            out = v
            for var, val in triple.items():
                out = self.set_fold(graph, out, i, var, val)
            return out
        var = rng.choice([x for x in VARS if x not in self.fixed_unity] or ["kern"])
        cands = self.candidates(graph, i, var, platform)
        cur = getattr(v, {"s_in": "s_in", "s_out": "s_out", "kern": "kern"}[var])[i]
        choices = [c for c in cands if c != cur] or cands
        return self.set_fold(graph, v, i, var, rng.choice(choices))

    # ------------------------------------------------------------------
    # brute-force enumeration space (paper §IV-B / Table IV)
    # ------------------------------------------------------------------
    def space(self, graph: HDGraph, platform: Platform,
              include_cuts: bool = True):
        """Yield (scopes, menus): independent decision slots and their menus."""
        slots: List[Tuple[int, str]] = []
        seen = set()
        for i in range(len(graph.nodes)):
            for var in VARS:
                if var in self.fixed_unity:
                    continue
                key = (tuple(self.scope(graph, i, var)), var)
                if key in seen:
                    continue
                seen.add(key)
                slots.append((i, var))
        menus = [self.candidates(graph, i, var, platform) for i, var in slots]
        return slots, menus

    def design_space_size(self, graph: HDGraph, platform: Platform,
                          include_cuts: bool = True,
                          per_node: bool = True) -> float:
        """|V| — the paper's Table-IV quantity. ``per_node=True`` counts the
        raw per-node space (before tying), matching how the paper reports
        backend spaces; tying reduces the searched space."""
        size = 1.0
        if per_node:
            for i, node in enumerate(graph.nodes):
                for var in VARS:
                    if var in self.fixed_unity:
                        continue
                    size *= max(1, len(self.candidates(graph, i, var, platform)))
        else:
            slots, menus = self.space(graph, platform)
            for m in menus:
                size *= max(1, len(m))
        if include_cuts:
            size *= 2.0 ** (len(graph.nodes) - 1)
        return size


SPMD = Backend(
    name="spmd",
    strict_kv=False,
    intra_matching=True,
    inter_matching=False,
    scan_tying=True,
    granularity={"s_in": "group", "s_out": "group", "kern": "group"},
)

MEGATRON = Backend(
    name="megatron",
    strict_kv=True,
    intra_matching=True,
    inter_matching=True,
    scan_tying=True,
    granularity={"s_in": "global", "s_out": "group", "kern": "global"},
)

SIMPLE = Backend(
    name="simple",
    strict_kv=True,
    intra_matching=False,
    inter_matching=True,
    scan_tying=True,
    granularity={"s_in": "global", "s_out": "global", "kern": "global"},
    fixed_unity=("s_in", "s_out"),
)

BACKENDS = {b.name: b for b in (SPMD, MEGATRON, SIMPLE)}
