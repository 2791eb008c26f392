"""Shared optimiser utilities: result container and feasibility repair."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.hdgraph import Variables, partitions_from_cuts
from repro_torch.core.objectives import Evaluation, Problem


@dataclass
class OptimResult:
    variables: Variables
    evaluation: Evaluation
    points: int                 # design points evaluated
    seconds: float
    history: List[Tuple[int, float]] = field(default_factory=list)
    name: str = ""

    @property
    def points_per_second(self) -> float:
        return self.points / self.seconds if self.seconds > 0 else float("inf")


def incumbent_better(cand_feasible: bool, cand_objective: float,
                     best_feasible: bool, best_objective: float) -> bool:
    """Feasibility-aware incumbent rule: a feasible candidate always beats an
    infeasible incumbent; among equally-feasible designs, lower O(V) wins.
    (An optimiser must never return an infeasible design when a feasible
    point was evaluated.)"""
    if cand_feasible and not best_feasible:
        return True
    if cand_feasible != best_feasible:
        return False
    return cand_objective < best_objective


def repair(problem: Problem, v: Variables, max_steps: int = 1024) -> Variables:
    """Greedy feasibility repair.

    The paper assumes V_init (all folds 1, fully split) is feasible; on TPU a
    single over-HBM node (e.g. a 384-expert MoE layer, or an embedding table
    with its optimiser state, on one chip) can violate Eq. 6 even fully
    split. Folding *reduces* per-chip residency (s_O shards weights, s_I/k
    shard the activation stash), so we walk the worst partition's folds
    upward, accepting any move that strictly shrinks its residency; when no
    fold helps, split the partition.
    """
    graph, backend, platform = problem.graph, problem.backend, problem.platform

    def part_residency(vv: Variables):
        evals = problem.evaluate(vv).node_evals
        parts = partitions_from_cuts(graph, vv.cuts)
        res = [sum(evals[i].hbm_resident for i in p) for p in parts]
        worst = max(range(len(parts)), key=lambda pi: res[pi])
        return parts, res, worst, evals

    def structural(vv: Variables) -> int:
        """Count of violations repair cannot fix (anything non-resource)."""
        return sum(1 for msg in problem.check(vv).violations
                   if not msg.startswith("partition"))

    base_structural = structural(v)

    for _ in range(max_steps):
        if problem.check(v).ok:
            return v
        parts, res, wi, evals = part_residency(v)
        worst = parts[wi]
        worst_res = res[wi]
        order = sorted(worst, key=lambda i: -evals[i].hbm_resident)
        best = None                      # (new_residency, Variables)
        for i in order:
            for var in ("s_out", "kern", "s_in"):
                cands = backend.candidates(graph, i, var, platform)
                cur = getattr(v, {"s_out": "s_out", "kern": "kern",
                                  "s_in": "s_in"}[var])[i]
                higher = [c for c in cands if c > cur]
                if not higher:
                    continue
                v2 = backend.set_fold(graph, v, i, var, higher[0])
                if structural(v2) > base_structural:
                    continue             # would break realisability/matching
                parts2, res2, wi2, _ = part_residency(v2)
                # residency of the partition containing node i after the move
                pi2 = next(p for p in range(len(parts2))
                           if worst[0] in parts2[p])
                if res2[pi2] < worst_res - 1e-9:
                    if best is None or res2[pi2] < best[0]:
                        best = (res2[pi2], v2)
            if best is not None:
                break                    # fattest node fixed first
        if best is not None:
            v = best[1]
            continue
        # no fold helps: split the worst partition at its midpoint
        edges = [e for e in graph.cut_edges if e not in v.cuts]
        inner = [e for e in edges if worst[0] <= e < worst[-1]]
        if not inner:
            return v                     # single node over capacity: give up
        v = v.with_cuts(tuple(sorted(set(v.cuts) | {inner[len(inner) // 2]})))
    return v
