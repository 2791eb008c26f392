"""Rule-Based optimiser (paper §IV-D, Algorithm 2).

Deterministic: per partition, repeatedly find the slowest node and apply the
folding increment with the smallest predicted resource change; propagate
matching constraints; stop when out of resources or fully parallel. Then
iteratively merge partitions that meet the paper's heuristics:
  - the partition is memory-bound,
  - its slowest node is fully unrolled,
  - its latency is smaller than the reconfiguration time.
Each merge is kept only if the merged design can be repaired to feasibility;
merged partitions are re-optimised.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

from repro_torch.core.hdgraph import Variables, partitions_from_cuts
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers.common import OptimResult, repair
from repro_torch.core.perfmodel import partition_time, t_conf
from repro_torch.obs import metrics as _metrics

VARS = ("s_in", "s_out", "kern")


def _slowest(problem: Problem, v: Variables, part: List[int]):
    evals = problem.evaluate(v).node_evals
    j = max(part, key=lambda i: evals[i].time)
    return j, evals


def _resource_vector(problem: Problem, v: Variables) -> Tuple[float, float]:
    """(collective bytes, HBM residency) — the TPU resource vector.

    On FPGA, folds consume DSP/BRAM at different rates, and Algorithm 2 picks
    the cheapest. On TPU every fold consumes chips equally; what
    differentiates folds is the ICI bandwidth they commit (TP all-reduce /
    ring-KV / EP all-to-all) and per-chip HBM residency. Lexicographic order
    makes the greedy prefer collective-free folds first — the analogue of the
    paper's smallest-resource-increment rule."""
    evals = problem.evaluate(v).node_evals
    return (sum(e.collective_bytes for e in evals),
            sum(e.hbm_resident for e in evals))


def optimise_partition(problem: Problem, v: Variables, part: List[int],
                       max_steps: int = 512,
                       batch_probes: bool = True) -> Tuple[Variables, int]:
    """Algorithm 2, lines 1-8.

    Under the streaming model (Eq. 2: max over nodes) only the slowest node
    matters; under the spmd model (sum over nodes) every node does. We keep
    the paper's slowest-first order but, when the slowest node has no
    improving move, continue with the next-slowest instead of stopping —
    identical to Algorithm 2 for streaming, strictly better for spmd.

    Improvement is judged on the PARTITION time T(P_i), not the node time:
    under streaming max-semantics the two coincide (the slowest node IS the
    interval); under spmd the partition time additionally carries the
    modelled resharding collectives at internal layout mismatches, so the
    greedy prefers layout-compatible folds when node times tie.

    ``batch_probes`` evaluates all of a step's candidate fold increments
    for the slowest node as ONE ``BatchedEvaluator.evaluate_batch`` call
    (plus the incumbent, so both sides of every comparison carry the same
    rounding) instead of one scalar ``problem.evaluate`` per probe. The
    greedy walks the identical move sequence — the decision quantities
    (feasibility, partition time, collective-bytes/residency resource
    vector) agree with the scalar path to 1e-9 and ties are broken in the
    same probe order."""
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    points = 0
    blocked: set = set()
    max_steps = max(max_steps, 16 * len(part))
    # index of `part` among the partitions (cuts are fixed in this routine)
    pidx = next(i for i, p in enumerate(partitions_from_cuts(graph, v.cuts))
                if p[0] == part[0])
    # Eq. 3/4: every partition after the first also pays its reconfiguration
    # (weight-streaming swap); amortised by the batch for throughput. The
    # greedy must see it, or it picks replicated-weight folds whose swaps
    # dwarf the compute.
    amort = (1.0 if problem.objective == "latency"
             else 1.0 / max(problem.batch_amortisation, 1))

    def part_cost(ev, vv):
        t = ev.partition_times[pidx]
        if pidx > 0:
            t += amort * t_conf(graph, part, vv, platform)
        return t

    for _ in range(max_steps):
        candidates_left = [i for i in part if i not in blocked]
        if not candidates_left:
            break
        ev_now = problem.evaluate(v)
        evals = ev_now.node_evals
        j = max(candidates_left, key=lambda i: evals[i].time)
        best: Optional[Tuple[Tuple[float, float], Variables, float]] = None

        # Candidate moves for the slowest node. On FPGA, Algorithm 2 bumps
        # one fold by an increment; the TPU fold menus are so coarse (3-4
        # mesh-realisable values per variable) that single-variable raises
        # cannot cross between e.g. TP-heavy (1,16,16) and DP-heavy
        # (1,1,256) designs — so the "increment" generalises to the node's
        # whole joint menu (a few dozen triples), still greedy, still
        # smallest-resource-change-first.
        menus = {var: backend.candidates(graph, j, var, platform)
                 for var in VARS}
        cur = (v.s_in[j], v.s_out[j], v.kern[j])
        triples = [
            (si, so, kk)
            for si in menus["s_in"] for so in menus["s_out"]
            for kk in menus["kern"]
            if (si, so, kk) != cur and platform.folds_realizable((si, so, kk))
        ]
        cands = []
        for si, so, kk in triples:
            v2 = v
            for var, val in zip(VARS, (si, so, kk)):
                v2 = backend.set_fold(graph, v2, j, var, val)
            cands.append(v2)
        if batch_probes and cands:
            # one batched evaluate for the whole probe set, with the
            # incumbent as row 0 so every comparison is batched-vs-batched
            res = problem.evaluate_many([v] + cands)
            points += len(cands)

            def b_cost(r: int, vv: Variables) -> float:
                t = float(res.part_times[r][pidx])
                if pidx > 0:
                    t += amort * t_conf(graph, part, vv, platform)
                return t

            t_part = b_cost(0, v)
            r_prev = (float(res.node_collective[0].sum()),
                      float(res.node_resident[0].sum()))
            for r, v2 in enumerate(cands, start=1):
                if not res.feasible[r]:
                    continue
                t_new = b_cost(r, v2)
                if t_new >= t_part - 1e-15:
                    continue
                dr = (float(res.node_collective[r].sum()) - r_prev[0],
                      float(res.node_resident[r].sum()) - r_prev[1])
                if best is None or dr < best[0]:
                    best = (dr, v2, t_new)
        else:
            t_part = part_cost(ev_now, v)
            r_prev = _resource_vector(problem, v)
            for v2 in cands:
                ev2 = problem.evaluate(v2)
                points += 1
                if not ev2.feasible:
                    continue
                t_new = part_cost(ev2, v2)
                if t_new >= t_part - 1e-15:
                    continue
                r_new = _resource_vector(problem, v2)
                dr = (r_new[0] - r_prev[0], r_new[1] - r_prev[1])
                if best is None or dr < best[0]:
                    best = (dr, v2, t_new)
        if best is None:
            blocked.add(j)              # node out of resources / fully parallel
            continue
        v = best[1]
        # A move can unblock nodes whose folds it changed (variable tying):
        # unblock the whole partition's tied scopes — cheap relative to
        # the probe loop, and joint moves can shift several variables.
        for var in VARS:
            for i in backend.scope(graph, j, var, v.cuts):
                blocked.discard(i)
    return v, points


def _fully_unrolled(problem: Problem, v: Variables, j: int) -> bool:
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    for var in VARS:
        cands = backend.candidates(graph, j, var, platform)
        cur = {"s_in": v.s_in, "s_out": v.s_out, "kern": v.kern}[var][j]
        if any(c > cur for c in cands):
            return False
    return True


def _meets_merge_heuristics(problem: Problem, v: Variables,
                            part: List[int]) -> bool:
    evals = problem.evaluate(v).node_evals
    j = max(part, key=lambda i: evals[i].time)
    memory_bound = evals[j].bottleneck == "memory"
    unrolled = _fully_unrolled(problem, v, j)
    tp = partition_time(problem.graph, part, evals, problem.exec_model)
    tc = t_conf(problem.graph, part, v, problem.platform)
    return memory_bound or unrolled or tp < tc


def _seeded_candidates(problem: Problem) -> List[Variables]:
    """Canonical single-partition seeds: uniform (s_in, s_out, k) triples
    over the whole graph (pure-DP, Megatron TP x DP, TP-only, SP x TP ...).

    Multi-start for the deterministic greedy: the TPU fold menu is so
    coarse that V_init (fully split, folds 1) cannot reach some globally
    uniform designs by single-node moves; seeding the classic designs and
    letting Algorithm 2 refine them fixes that. Each seed is clamped
    per-node to the channel-factor constraint by set_fold."""
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    n = len(graph.nodes)
    seeds = []
    values = platform.fold_values()
    uniform = []
    for si in values:
        for so in values:
            for kk in values:
                if si * so * kk > platform.chips:
                    continue
                if not platform.folds_realizable((si, so, kk)):
                    continue
                if si * so * kk < platform.chips // 4:
                    continue            # underusing the mesh: never optimal
                uniform.append((si, so, kk))
    for si, so, kk in uniform:
        v = Variables((), tuple([1] * n), tuple([1] * n), tuple([1] * n))
        for j in range(n):
            for var, val in zip(VARS, (si, so, kk)):
                v = backend.set_fold(graph, v, j, var, val)
        v = repair(problem, v)
        seeds.append(v)
    return seeds


def _algorithm2(problem: Problem,
                time_budget_s: Optional[float] = None,
                multi_start: bool = True):
    """Algorithm 2's control flow as a GENERATOR of descent requests.

    Yields ``(v, part)`` every time a partition must be greedily optimised
    (lines 1-8) and expects ``(v_optimised, probe_points)`` back via
    ``send``; returns the final ``OptimResult`` through ``StopIteration``.
    All other work — seeding, merge heuristics, repair, objective
    comparisons, history bookkeeping — happens here on the host, in
    float64, through the scalar reference ``problem.evaluate``.

    This split is what lets every engine (and the fleet) share ONE copy of
    the outer merge loop: the scalar/numpy engines answer each request
    with the host ``optimise_partition``, the jax engine with the jitted
    device descent (``core/accel/search_loops.DeviceRuleBased``), and
    ``core/accel/fleet.fleet_rule_based`` round-robins MANY problems'
    generators against one vmapped descent so a whole portfolio's greedy
    descents advance in lockstep. As long as a driver returns the same
    optimised folds the scalar reference would, the chosen merge sequence
    — and hence the final design, objective and history — is identical by
    construction.
    """
    graph = problem.graph
    start = time.perf_counter()
    points = 0
    history = []

    v = repair(problem, problem.backend.initial(graph))

    # lines 10-12: optimise partitions independently
    for part in partitions_from_cuts(graph, v.cuts):
        v, p = yield (v, part)
        points += p
    history.append((points, problem.evaluate(v).objective))

    # multi-start: refine the canonical uniform seeds too, keep the best.
    if multi_start:
        best_v, best_obj = v, problem.evaluate(v).objective
        feasible_best = problem.evaluate(v).feasible
        for seed in _seeded_candidates(problem):
            if time_budget_s is not None and \
                    time.perf_counter() - start > 0.5 * time_budget_s:
                break
            sv = seed
            for part in partitions_from_cuts(graph, sv.cuts):
                sv, p = yield (sv, part)
                points += p
            ev = problem.evaluate(sv)
            points += 1
            if ev.feasible and (not feasible_best or ev.objective < best_obj):
                best_v, best_obj, feasible_best = sv, ev.objective, True
        v = best_v
        history.append((points, best_obj))

    # lines 13-17: merge loop. Forward-greedy sweeps: a partition that meets
    # the heuristics tries to absorb a neighbour (keeping folds, repairing,
    # re-optimising in place); on success it stays put and tries to absorb
    # again, so a chain collapses in one O(P) sweep instead of O(P^2).
    changed = True
    sweeps = 0
    timed_out = False
    while changed and sweeps < 8 and not timed_out:
        sweeps += 1
        changed = False
        pi = 0
        while True:
            parts = partitions_from_cuts(graph, v.cuts)
            if pi >= len(parts) or len(parts) == 1:
                break
            if time_budget_s is not None and \
                    time.perf_counter() - start > time_budget_s:
                timed_out = True
                break
            part = parts[pi]
            # The paper's heuristics prune merge attempts for the streaming
            # model, where a merge forces two nodes to share chips and is
            # usually harmful. Under the spmd (time-multiplexed full-mesh)
            # model a merge never raises partition times — folds are kept —
            # so every merge is worth attempting; the objective comparison
            # below rejects the bad ones.
            if problem.exec_model != "spmd" and \
                    not _meets_merge_heuristics(problem, v, part):
                pi += 1
                continue
            cut_candidates = []
            if pi < len(parts) - 1:
                cut_candidates.append(part[-1])         # cut after partition
            if pi > 0:
                cut_candidates.append(part[0] - 1)      # cut before partition
            baseline = problem.evaluate(v)
            merged = None
            best_obj = None
            for cut in cut_candidates:
                v2 = v.with_cuts(tuple(c for c in v.cuts if c != cut))
                new_parts = partitions_from_cuts(graph, v2.cuts)
                target = next(p for p in new_parts if part[0] in p)
                v2 = problem.backend.propagate(graph, v2)
                v2 = repair(problem, v2)
                v2, p = yield (v2, target)
                points += p
                ev2 = problem.evaluate(v2)
                points += 1
                if not ev2.feasible:
                    continue
                if best_obj is None or ev2.objective < best_obj:
                    merged, best_obj = v2, ev2.objective
            # A tie only counts as a merge if the cut actually stayed
            # removed: repair may split the partition straight back
            # (re-adding a cut), and accepting that no-op candidate at
            # equal objective re-attempts the identical merge forever.
            # The livelock needs a repair-driven split to trigger, which
            # none of the power-of-two platforms do — the 3-wide
            # sub-meshes co-mapping carves (docs/comapping.md) found it.
            # Strict improvements are always kept, so any run that
            # terminated before is unchanged.
            if merged is None or best_obj > baseline.objective or (
                    best_obj >= baseline.objective
                    and len(merged.cuts) >= len(v.cuts)):
                pi += 1
                continue
            v = merged
            changed = True
            history.append((points, best_obj))
            # stay at the same index: the merged partition may absorb again

    # final consolidation: cheap cut-removal sweeps (folds kept, repair
    # only — no re-optimisation probes), then one more optimise pass per
    # surviving partition. Recovers merges the in-loop objective test
    # rejected only because the kept folds were transiently suboptimal.
    for _ in range(4):
        removed = False
        for cut in sorted(v.cuts):
            if time_budget_s is not None and \
                    time.perf_counter() - start > 2 * time_budget_s:
                break
            v2 = problem.backend.propagate(
                graph, v.with_cuts(tuple(c for c in v.cuts if c != cut)))
            v2 = repair(problem, v2)
            ev2 = problem.evaluate(v2)
            points += 1
            if ev2.feasible and ev2.objective < problem.evaluate(v).objective:
                v = v2
                removed = True
        if not removed:
            break
    for part in partitions_from_cuts(graph, v.cuts):
        v, p = yield (v, part)
        points += p
    history.append((points, problem.evaluate(v).objective))

    elapsed = time.perf_counter() - start
    return OptimResult(v, problem.evaluate(v), points, elapsed, history,
                       name="rule_based")


def drive(gen, descend) -> OptimResult:
    """Run an ``_algorithm2`` generator to completion against a descent
    callable ``descend(v, part) -> (v_optimised, probe_points)``."""
    try:
        req = next(gen)
        while True:
            req = gen.send(descend(*req))
    except StopIteration as stop:
        return stop.value


def optimise(problem: Problem,
             time_budget_s: Optional[float] = None,
             multi_start: bool = True,
             engine: str = "torch",
             device=None) -> OptimResult:
    # ``engine`` selects how Algorithm 2's greedy descents run: "scalar"
    # keeps the original one-evaluate-per-probe loop; "numpy" batches each
    # greedy step's probe set through BatchedEvaluator.evaluate_batch;
    # "torch" (default; "auto" resolves to it) runs each descent on the
    # card — probe construction, evaluation and argmax selection as device
    # tensor steps (core/accel/search_loops.DeviceRuleBased), choosing the
    # identical move sequence. ``device`` places the torch engine (default
    # cuda; "cpu" runs the kernels' plain versions, as the tests do). The
    # outer merge loop (_algorithm2) is shared verbatim by all three.
    from repro_torch.core.accel import resolve_engine
    eng = resolve_engine(engine)
    if eng == "torch":
        from repro_torch.core.accel.search_loops import DeviceRuleBased
        descend = DeviceRuleBased(problem, device=device).descend
    elif device is not None:
        raise ValueError(f"device= applies to the torch engine only; "
                         f"engine resolved to {eng!r}")
    else:
        batch_probes = eng != "scalar"

        def descend(v, part):
            return optimise_partition(problem, v, part,
                                      batch_probes=batch_probes)

    result = drive(_algorithm2(problem, time_budget_s, multi_start), descend)
    _metrics.note_result(result, engine=eng)
    return result
