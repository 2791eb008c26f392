"""Joint search for multi-network co-mapping (the port of
``repro.core.comap``).

``joint_search`` optimises a ``CoMapProblem`` — N networks, one shared
platform, the resource partition between nets part of the candidate —
on each engine of the port:

  scalar / numpy   one per-(split, net) optimiser run per lane, through
                   the requested host engine (the float64 reference).
  torch            ALL S x N lanes in one call of the fleet entry point
                   of the optimiser (``core/accel/comap_fleet.py``): the
                   lanes of a bucket are one lane-stacked device pass, so
                   brute-force chunks, SA sweeps and the rule-based
                   descents search every lane of the joint space at once,
                   with one segred launch a step, sweep or chunk.

Why the decomposition is exact: each composite objective (weighted
throughput, worst-case latency, max-min fairness) is monotone in every
net's own Eq. 5 objective, and under one split the nets' resources are
disjoint, so the joint optimum over (split, designs) is the per-lane
optimum combined across lanes — no candidate coupling is lost. The one
genuinely coupled constraint, the shared chip budget, is evaluated
inside the candidate (``CoMapProblem.budget_violations`` gates each
split before it may win), which is also where user-supplied
over-committed split menus are rejected.

Engine identity: a fleet lane is bitwise its per-problem torch run, and
the combine below is shared float64 host arithmetic over the
deterministic split order, so the chosen split, per-net designs,
composite objective and improvement history follow the per-lane results:
equal to the numpy engine's for brute force and rule based (where the
float32 descent walks the scalar move sequence), and bitwise the per-lane
torch loop for all three. Annealing's device generator is another
explorer than the host's by design, so its contract is determinism for
a seed and fleet == per-lane loop.

Only the engine dispatch of ``joint_search`` and the fleet kwarg sets
(``device`` beside the JAX package's ``devices``) differ from the JAX
package's module. ``devices=D`` reaches the fleet, which shards each
bucket's lanes over D devices, bitwise ``devices=None``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core.objectives import (
    CoMapEvaluation,
    CoMapProblem,
    combine_composite,
)
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.optimizers.common import OptimResult
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["CoMapPlan", "CoMapResult", "joint_search"]


@dataclass
class CoMapResult:
    """Joint-search analogue of ``optimizers.common.OptimResult``.

    ``history`` is the composite improvement trajectory over the
    deterministic split order: after each split's N lanes complete,
    cumulative points advance by their point counts and a feasible
    composite that beats the incumbent appends ``(points, composite)``.
    Identical across engines whenever the per-lane results are.
    """

    problem: CoMapProblem
    split_index: int                    # -1 when no feasible split
    split: Tuple[int, ...]              # () when none
    per_net: Tuple[OptimResult, ...]    # winning split's lane results
    evaluation: CoMapEvaluation         # scalar-reference composite
    points: int                         # design points across ALL lanes
    seconds: float
    history: List[Tuple[int, float]]
    name: str


@dataclass
class CoMapPlan:
    """Deployable artefact of ``pipeline.optimise_comapping``: the
    winning resource split plus one exported ``ShardingPlan`` per net,
    each against its own disjoint sub-platform. ``plans`` is empty when
    no split is feasible (``feasible`` False, ``objective_value`` inf)."""

    split_index: int
    split: Tuple[int, ...]
    plans: tuple                       # Tuple[ShardingPlan, ...], net order
    objective: str                     # composite objective name
    objective_value: float
    feasible: bool
    result: CoMapResult


#: optimiser kwargs each fleet entry point covers (mirrors
#: ``pipeline.optimise_portfolio``); anything else forces the
#: per-lane loop, which the fleet is bit-identical to anyway
FLEET_KWARGS = {
    "brute_force": {"include_cuts", "max_cuts", "max_points",
                    "batch_size", "devices", "device"},
    "annealing": {"seed", "k_start", "k_min", "cooling", "max_iters",
                  "objective_scale", "chains", "devices", "device"},
    "rule_based": {"multi_start", "devices", "device"},
}


def joint_search(cp: CoMapProblem, optimiser: str = "rule_based",
                 engine: str = "auto", **optimiser_kwargs) -> CoMapResult:
    """Optimise one ``CoMapProblem`` (see module docstring)."""
    from repro_torch.core.accel import resolve_engine

    if optimiser not in OPTIMIZERS:
        raise ValueError(f"unknown optimiser {optimiser!r}; choose from "
                         f"{sorted(OPTIMIZERS)}")
    eng = resolve_engine(engine)
    t0 = time.monotonic()
    menu = cp.resolved_splits()
    S, N = len(menu), cp.n_nets
    with _trace.span("comap.joint_search", optimiser=optimiser,
                     engine=eng, splits=S, nets=N):
        if S == 0:
            name0, size0 = cp.platform.mesh_axes[0]
            reason = (f"no resource split fits: mesh axis {name0}={size0} "
                      f"cannot host {N} nets")
            return CoMapResult(
                problem=cp, split_index=-1, split=(), per_net=(),
                evaluation=cp.infeasible_evaluation(reason), points=0,
                seconds=time.monotonic() - t0, history=[],
                name=f"comap_{optimiser}")
        lanes = [cp.subproblem(s, i) for s in range(S) for i in range(N)]
        _metrics.counter("comap.lanes").inc(len(lanes))
        if (eng == "torch" and optimiser in FLEET_KWARGS
                and set(optimiser_kwargs) <= FLEET_KWARGS[optimiser]):
            from repro_torch.core.accel.comap_fleet import fleet_comap
            results = fleet_comap(lanes, optimiser, **optimiser_kwargs)
        else:
            with _trace.span("comap.lane_loop", lanes=len(lanes),
                             engine=eng):
                results = [OPTIMIZERS[optimiser](p, engine=eng,
                                                 **optimiser_kwargs)
                           for p in lanes]
        return _combine(cp, optimiser, results, t0)


def _combine(cp: CoMapProblem, optimiser: str,
             results: List[OptimResult], t0: float) -> CoMapResult:
    """Shared float64 host combine over the deterministic split order —
    the engine-independent half of the joint search."""
    menu = cp.resolved_splits()
    S, N = len(menu), cp.n_nets
    weights = cp.net_weights
    best_s, best_comp = -1, math.inf
    points_cum = 0
    history: List[Tuple[int, float]] = []
    for s in range(S):
        lane = results[s * N:(s + 1) * N]
        points_cum += sum(r.points for r in lane)
        feasible = (not cp.budget_violations(s)
                    and all(r.evaluation.feasible for r in lane))
        if not feasible:
            continue
        comp = combine_composite(cp.objective, weights,
                                 [r.evaluation for r in lane])
        if comp < best_comp:
            best_s, best_comp = s, comp
            history.append((points_cum, comp))
    seconds = time.monotonic() - t0
    if best_s < 0:
        return CoMapResult(
            problem=cp, split_index=-1, split=(), per_net=(),
            evaluation=cp.infeasible_evaluation(
                f"every one of the {S} resource splits is infeasible"),
            points=points_cum, seconds=seconds, history=history,
            name=f"comap_{optimiser}")
    winners = tuple(results[best_s * N:(best_s + 1) * N])
    evaluation = cp.evaluate(best_s, [r.variables for r in winners])
    _metrics.counter("comap.searches").inc()
    return CoMapResult(
        problem=cp, split_index=best_s, split=menu[best_s],
        per_net=winners, evaluation=evaluation, points=points_cum,
        seconds=seconds, history=history, name=f"comap_{optimiser}")
