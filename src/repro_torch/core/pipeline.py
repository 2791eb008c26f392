"""End-to-end SAMO pipeline of the port: parse -> optimise -> export.

    plan = optimise_mapping(arch, shape, platform, backend="spmd",
                            optimiser="rule_based", objective="throughput",
                            engine="torch")

    plans = optimise_portfolio(["tinyllama-1.1b", "llama3.2-1b"], shape,
                               [V5E_POD, V5E_2POD],         # per-model
                               optimiser="brute_force")     # platforms

    comap = optimise_comapping(["tinyllama-1.1b", "llama3.2-1b"], shape,
                               V5E_POD)    # two nets sharing one pod

The same entry points as ``repro.core.pipeline``'s. Engines:

  engine   brute_force           annealing             rule_based
  -------  --------------------  --------------------  --------------------
  scalar   one point at a time   one chain (or         scalar probe loop
           (reference)           tempering), host      (reference)
  numpy    chunked host batches  tempering, one batch  each greedy step's
                                 a sweep, host         probes as one batch
  torch    chunk decode and      multi-chain sweeps    each greedy step on
           evaluation on the     on the card, one      the card
           card, one readback    readback a block
           a chunk

``torch`` is the default, and ``auto`` resolves to it.

On the card the partition-time reduction of every candidate with a cut
runs in the hand-written segred kernel. Brute force's torch engine returns
the numpy engine's optimum, point count and history; rule-based walks the
scalar reference's move sequence; annealing is deterministic for a seed.
``annealing`` also takes ``engine="host"`` (the host engines by chain
count).

The torch engine runs on ``cuda``; ``device="cpu"`` (an optimiser kwarg)
runs it on the CPU with the kernels' plain versions. With no card and no
``device="cpu"`` it raises ``EngineUnavailable``. Returned ``Evaluation``
objects are always re-derived through the float64 scalar reference.

``optimise_portfolio`` searches many (arch, platform, objective) problems
as fleets on the card (``core/accel/fleet.py``): each bucket of problems is
one lane-stacked device program, with per-problem results bitwise those of
a per-problem ``optimise_mapping`` loop.

``optimise_comapping`` maps N networks onto one shared platform, the
split of its leading mesh axis between them part of the search: every
(split, net) sub-problem is a lane of one fleet call (``core/comap.py``,
``core/accel/comap_fleet.py``), and the per-net optima are combined into
the composite objective on the host in float64.

``devices=D`` shards the search over D devices (``runtime.device_mesh``:
the cards, or D logical shards of ``device``), with results bitwise those
of ``devices=None``: brute force splits each chunk's rows
(``optimise_mapping(optimiser="brute_force", devices=D)``), the fleets
each bucket's lanes (``optimise_portfolio`` and ``optimise_comapping``).
On one card the shards run one after another.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.backends import BACKENDS
from repro_torch.core.exporter import ShardingPlan, export_plan
from repro_torch.core.graph_builder import build_hdgraph
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.perfmodel import ModelOptions
from repro_torch.core.platform import Platform, V5E_POD
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def make_problem(arch: ArchConfig, shape: ShapeSpec,
                 platform: Platform = V5E_POD,
                 backend: str = "spmd",
                 objective: str = "throughput",
                 exec_model: str = "streaming",
                 opts: Optional[ModelOptions] = None,
                 **model_opts) -> Problem:
    """``model_opts`` are ModelOptions fields (zero1=True, ...) used when no
    explicit ``opts`` is given."""
    if opts is not None and model_opts:
        raise TypeError(f"pass either opts= or ModelOptions fields "
                        f"{sorted(model_opts)}, not both")
    graph = build_hdgraph(arch, shape)
    return Problem(
        graph=graph,
        platform=platform,
        backend=BACKENDS[backend],
        objective=objective,
        exec_model=exec_model,
        opts=opts or ModelOptions(**model_opts),
    )


def optimise_mapping(arch: ArchConfig, shape: ShapeSpec,
                     platform: Platform = V5E_POD,
                     backend: str = "spmd",
                     optimiser: str = "rule_based",
                     objective: str = "throughput",
                     exec_model: str = "streaming",
                     opts: Optional[ModelOptions] = None,
                     engine: Optional[str] = None,
                     **optimiser_kwargs) -> ShardingPlan:
    """``engine`` selects the evaluation engine (see the module docstring);
    None keeps the optimiser's default (torch). Remaining kwargs go to the
    optimiser entry point (``device=`` among them, and brute force's
    ``devices=``)."""
    if optimiser not in OPTIMIZERS:
        raise ValueError(f"unknown optimiser {optimiser!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    with _trace.span("pipeline.optimise_mapping", arch=arch.name,
                     optimiser=optimiser, backend=backend,
                     objective=objective, engine=engine or "default"):
        with _trace.span("pipeline.make_problem"):
            problem = make_problem(arch, shape, platform, backend,
                                   objective, exec_model, opts)
        if engine is not None:
            optimiser_kwargs["engine"] = engine
        with _trace.span("pipeline.optimise", optimiser=optimiser):
            result = OPTIMIZERS[optimiser](problem, **optimiser_kwargs)
        with _trace.span("pipeline.export_plan"):
            return export_plan(problem.graph, result.variables, platform,
                               exec_model, result.evaluation)


#: the kwargs each fleet takes; anything else runs the per-problem loop
FLEET_KWARGS = {
    "brute_force": {"include_cuts", "max_cuts", "max_points",
                    "batch_size", "devices", "device"},
    "annealing": {"seed", "k_start", "k_min", "cooling", "max_iters",
                  "objective_scale", "chains", "devices", "device"},
    "rule_based": {"multi_start", "devices", "device"},
}


def optimise_portfolio(archs: Sequence, shapes,
                       platform=V5E_POD,
                       backend: str = "spmd",
                       optimiser: str = "brute_force",
                       objective: str = "throughput",
                       exec_model: str = "streaming",
                       opts: Optional[ModelOptions] = None,
                       engine: str = "auto",
                       devices: Optional[int] = None,
                       results: Optional[list] = None,
                       **optimiser_kwargs) -> List[ShardingPlan]:
    """Optimise a whole portfolio of (architecture, platform) pairs in one
    fleet sweep.

    ``archs`` is a sequence of ``ArchConfig``s (or registry names);
    ``shapes`` is one ``ShapeSpec`` applied to every arch, or a matching
    sequence; ``platform`` and ``objective`` are likewise one value or a
    matching per-problem sequence. Platform scalars, fold tables, the Eq. 5
    objective and the Eq. 4 amortisation factor are device data, so a
    mixed portfolio shares buckets like a uniform one. Mismatched sequence
    lengths raise ``ValueError`` up front.

    With the ``torch`` engine (the ``auto`` default) the problems are
    bucketed by program shape and each bucket is searched by one
    lane-stacked device program (``core/accel/fleet.py``), for all three
    optimisers; per-problem optima, objectives and improvement histories
    are identical to looping ``optimise_mapping(engine="torch")``. Other
    engines, and kwargs outside a fleet's set (``time_budget_s`` in
    particular, whose wall-clock truncation a lockstep bucket cannot
    reproduce), run the per-problem loop. Returns one ``ShardingPlan`` per
    arch, in input order.

    Duplicate problems — equal ``lowering.problem_fingerprint`` — are
    optimised ONCE and the result fans out to every duplicate (the
    ``pipeline.portfolio.coalesced`` counter records how many); budgeted
    calls keep per-duplicate runs. ``results``, a list, receives each
    problem's ``OptimResult`` (points and improvement history, which a plan
    does not hold), in input order.

    ``devices=D`` (torch engine only) shards each fleet bucket's lanes
    over D devices, bitwise ``devices=None``. Brute force may also take
    it on the per-problem loop (each problem's chunks sharded); SA and
    rule-based kwargs that force the loop raise ``ValueError`` rather
    than drop it.
    """
    from repro_torch.configs import get_arch
    from repro_torch.core.accel import resolve_engine

    # Validate the three input sequences up front with clear errors: a
    # silent zip truncation (or a bare string iterated character by
    # character) used to surface as a baffling failure deep in the
    # lowering instead of here.
    if isinstance(archs, str):
        raise ValueError(
            f"archs must be a sequence of ArchConfigs or registry names; "
            f"got the single string {archs!r} — wrap it in a list")
    archs = [get_arch(a) if isinstance(a, str) else a for a in archs]
    if isinstance(shapes, str) or isinstance(platform, str):
        which = "shapes" if isinstance(shapes, str) else "platform"
        raise ValueError(f"{which} must not be a string — a string would "
                         f"iterate character by character; pass a "
                         f"ShapeSpec/Platform or a sequence of them")
    shapes = [shapes] * len(archs) if isinstance(shapes, ShapeSpec) \
        else list(shapes)
    if len(shapes) != len(archs):
        raise ValueError(f"got {len(archs)} archs but {len(shapes)} "
                         f"shapes; pass one ShapeSpec or exactly one "
                         f"shape per arch")
    platforms = [platform] * len(archs) if isinstance(platform, Platform) \
        else list(platform)
    if len(platforms) != len(archs):
        raise ValueError(f"got {len(archs)} archs but {len(platforms)} "
                         f"platforms; pass one Platform or exactly one "
                         f"platform per arch")
    objectives = [objective] * len(archs) if isinstance(objective, str) \
        else list(objective)
    if len(objectives) != len(archs):
        raise ValueError(f"got {len(archs)} archs but {len(objectives)} "
                         f"objectives; pass one objective or exactly one "
                         f"per arch")
    if optimiser not in OPTIMIZERS:
        raise ValueError(f"unknown optimiser {optimiser!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    with _trace.span("pipeline.make_problems", count=len(archs)):
        problems = [make_problem(a, s, p, backend, o, exec_model, opts)
                    for a, s, p, o in
                    zip(archs, shapes, platforms, objectives)]
    eng = resolve_engine(engine)
    # Identical Problems — same canonical lowered program, hence identical
    # results from every deterministic engine — are searched once and the
    # result fans out. Wall-clock budgets are the one knob that makes
    # re-runs non-identical, so budgeted calls keep per-duplicate runs.
    alias_of: dict = {}
    unique_idx = list(range(len(problems)))
    if len(problems) > 1 and "time_budget_s" not in optimiser_kwargs:
        from repro_torch.core.accel.lowering import problem_fingerprint
        with _trace.span("pipeline.dedupe", problems=len(problems)):
            first_at: dict = {}
            unique_idx = []
            for i, p in enumerate(problems):
                fp = problem_fingerprint(p)
                if fp in first_at:
                    alias_of[i] = first_at[fp]
                else:
                    first_at[fp] = i
                    unique_idx.append(i)
        if alias_of:
            _metrics.counter("pipeline.portfolio.coalesced").inc(
                len(alias_of))
    run_problems = [problems[i] for i in unique_idx]
    if devices is not None:
        if eng != "torch":
            raise ValueError(
                f"devices={devices} requires the torch engine (sharded "
                f"fleets); engine resolved to {eng!r}")
        optimiser_kwargs["devices"] = devices
    if eng == "torch" and set(optimiser_kwargs) <= FLEET_KWARGS[optimiser]:
        from repro_torch.core.accel.fleet import (
            fleet_annealing,
            fleet_brute_force,
            fleet_rule_based,
        )
        runner = {"brute_force": fleet_brute_force,
                  "annealing": fleet_annealing,
                  "rule_based": fleet_rule_based}[optimiser]
        with _trace.span("pipeline.optimise_portfolio.fleet",
                         optimiser=optimiser,
                         problems=len(run_problems)):
            found = runner(run_problems, **optimiser_kwargs)
        # the fleet runners bypass the optimiser entry points (which note
        # their own results), so account for their results here
        for r in found:
            _metrics.note_result(r, engine="fleet")
    else:
        if "devices" in optimiser_kwargs and optimiser != "brute_force":
            extra = sorted(set(optimiser_kwargs)
                           - FLEET_KWARGS.get(optimiser, set()))
            raise ValueError(
                f"devices= for optimiser {optimiser!r} is only available "
                f"on the fleet path; kwargs {extra} forced the "
                f"per-problem loop, which has no sharded engine")
        with _trace.span("pipeline.optimise_portfolio.loop",
                         optimiser=optimiser, engine=eng,
                         problems=len(run_problems)):
            found = [OPTIMIZERS[optimiser](p, engine=eng, **optimiser_kwargs)
                     for p in run_problems]
    # fan the unique results back out over the duplicates, input order
    pos = {orig: k for k, orig in enumerate(unique_idx)}
    all_results = [found[pos[alias_of.get(i, i)]]
                   for i in range(len(problems))]
    if results is not None:
        results.extend(all_results)
    with _trace.span("pipeline.export_plans", count=len(all_results)):
        return [export_plan(p.graph, r.variables, p.platform, exec_model,
                            r.evaluation)
                for p, r in zip(problems, all_results)]


def make_comap_problem(archs: Sequence, shape: ShapeSpec,
                       platform: Platform = V5E_POD,
                       backend: str = "spmd",
                       objective: str = "weighted_throughput",
                       weights: Optional[Sequence[float]] = None,
                       exec_model: str = "streaming",
                       opts: Optional[ModelOptions] = None,
                       splits: Optional[Sequence[Sequence[int]]] = None):
    """Build a ``CoMapProblem``: N architectures sharing ONE platform,
    the chip/HBM partition between them part of the decision space.
    ``archs`` are ArchConfigs or registry names; ``objective`` is a
    composite name from ``COMAP_OBJECTIVES``; ``splits`` optionally pins
    an explicit resource-split menu instead of the full axis-0
    composition enumeration."""
    from repro_torch.configs import get_arch
    from repro_torch.core.objectives import CoMapProblem

    if isinstance(archs, str):
        raise ValueError(
            f"archs must be a sequence of ArchConfigs or registry names; "
            f"got the single string {archs!r} — wrap it in a list")
    archs = [get_arch(a) if isinstance(a, str) else a for a in archs]
    graphs = tuple(build_hdgraph(a, shape) for a in archs)
    return CoMapProblem(
        graphs=graphs,
        platform=platform,
        backend=BACKENDS[backend],
        objective=objective,
        weights=None if weights is None else tuple(weights),
        exec_model=exec_model,
        opts=opts or ModelOptions(),
        splits=None if splits is None
        else tuple(tuple(int(p) for p in s) for s in splits),
    )


def optimise_comapping(archs: Sequence, shape: ShapeSpec,
                       platform: Platform = V5E_POD,
                       backend: str = "spmd",
                       optimiser: str = "rule_based",
                       objective: str = "weighted_throughput",
                       weights: Optional[Sequence[float]] = None,
                       exec_model: str = "streaming",
                       opts: Optional[ModelOptions] = None,
                       engine: str = "auto",
                       splits: Optional[Sequence[Sequence[int]]] = None,
                       **optimiser_kwargs):
    """Jointly map N networks onto one shared platform — the f-CNN^x
    multi-CNN scenario as a first-class problem type.

    Enumerates the resource-partition menu (or the explicit ``splits``),
    searches every per-(split, net) sub-problem with the requested
    optimiser — with the torch engine (the ``auto`` default), ALL S x N
    lanes in one fleet call (``core/accel/comap_fleet.py``) — and
    combines per-net optima into the composite ``objective`` on the host
    in float64 (exact: the composites are monotone per-net, see
    ``core/comap.py``). Returns a ``CoMapPlan`` whose ``plans`` hold one
    exported ``ShardingPlan`` per net against its disjoint sub-platform;
    an infeasible co-mapping (e.g. fewer leading-axis slices than nets)
    returns ``feasible=False`` with no plans rather than raising. The
    torch engine runs on the card unless ``device="cpu"`` is passed;
    ``devices=D`` shards the fleet's lanes over D devices, bitwise
    ``devices=None``."""
    from repro_torch.core.comap import CoMapPlan, joint_search

    with _trace.span("pipeline.optimise_comapping", nets=len(archs),
                     optimiser=optimiser, objective=objective,
                     engine=engine):
        cp = make_comap_problem(archs, shape, platform, backend,
                                objective, weights, exec_model, opts,
                                splits)
        result = joint_search(cp, optimiser=optimiser, engine=engine,
                              **optimiser_kwargs)
        if result.split_index < 0:
            return CoMapPlan(split_index=-1, split=(), plans=(),
                             objective=objective,
                             objective_value=result.evaluation.objective,
                             feasible=False, result=result)
        subplats = cp.split_platforms(result.split_index)
        with _trace.span("pipeline.export_plans", count=cp.n_nets):
            plans = tuple(
                export_plan(cp.graphs[i], r.variables, subplats[i],
                            exec_model, r.evaluation)
                for i, r in enumerate(result.per_net))
        return CoMapPlan(split_index=result.split_index,
                         split=result.split, plans=plans,
                         objective=objective,
                         objective_value=result.evaluation.objective,
                         feasible=result.evaluation.feasible,
                         result=result)


__all__ = ["make_problem", "optimise_mapping", "optimise_portfolio",
           "make_comap_problem", "optimise_comapping", "FLEET_KWARGS"]
