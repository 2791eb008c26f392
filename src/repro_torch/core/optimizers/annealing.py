"""Simulated Annealing optimiser (paper §IV-C, Algorithm 1).

Starts from the resource-minimal state (folds = 1, HD-Graph fully split),
applies random transformations, and accepts/rejects with the decision
function psi (Eq. 11): psi = exp(min(0, (O(V_prev) - O(V)) / K)) compared
against x ~ U(0,1). K decays geometrically by the cooling rate until K_min,
then (per the paper's evaluation setup) keeps running at K_min for any
remaining time budget.

Two modes:
  chains=1 (default) — the paper's single-chain algorithm, bit-identical to
      the original scalar implementation for a fixed seed (same rng stream,
      same accept decisions, same history), except that a feasible
      evaluation now always replaces an infeasible incumbent (bugfix: the
      repaired initial state can be infeasible, and the old code then never
      surrendered it to a feasible-but-higher-objective design).
  chains=K>1 — parallel tempering: K chains on a geometric temperature
      ladder stepped in lockstep, ONE batched evaluate per sweep
      (core/batched_eval.py), with periodic Metropolis replica exchanges
      between adjacent temperatures. Deterministic under a fixed seed.

Engines (core/accel registry): the two modes above run on the ``host``
engines (``host``, ``scalar`` and ``numpy`` select them by name).
``engine="torch"`` (the default; ``auto`` is torch) instead runs the sweep
loop on the card (``core/accel/search_loops.DeviceSA``): move proposal,
on-device feasibility repair (a masked clamp-and-propagate step for
strict-KV violations), evaluation, Metropolis acceptance and per-chain
incumbent tracking are device steps, driven by one ``torch.Generator`` on
the card — deterministic for a fixed seed, but a different rng stream
than the host engines and than the JAX package's ``jax.random`` (there
are no replica exchanges and fold moves always redraw the whole triple).
No sweep waits on the host; the traces are read back once per block of
sweeps, and without a time budget the whole schedule is one block.
``device="cpu"`` runs it on the CPU with the kernel's plain version.
"""
from __future__ import annotations

import math
import random
import time
from typing import List, Optional

from repro_torch.core.hdgraph import Variables
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers.common import OptimResult, incumbent_better, repair
from repro_torch.obs import metrics as _metrics

#: temperature ratio between adjacent parallel-tempering chains
LADDER_SPREAD = 1.6


def optimise(problem: Problem,
             seed: int = 0,
             k_start: float = 1000.0,
             k_min: float = 1.0,
             cooling: float = 0.98,
             time_budget_s: Optional[float] = None,
             max_iters: Optional[int] = None,
             objective_scale: Optional[float] = None,
             chains: int = 1,
             swap_interval: int = 16,
             engine: str = "torch",
             device=None) -> OptimResult:
    if engine not in ("host", "scalar", "numpy", "batched"):
        from repro_torch.core.accel import resolve_engine
        engine = resolve_engine(engine)
    if engine != "torch" and device is not None:
        raise ValueError(f"device= applies to the torch engine only; "
                         f"engine resolved to {engine!r}")
    if engine == "torch":
        result = _optimise_torch(problem, seed, k_start, k_min, cooling,
                                 time_budget_s, max_iters, objective_scale,
                                 max(chains, 1), device=device)
    elif chains <= 1:
        result = _optimise_single(problem, seed, k_start, k_min, cooling,
                                  time_budget_s, max_iters, objective_scale)
    else:
        result = _optimise_tempering(problem, seed, k_start, k_min, cooling,
                                     time_budget_s, max_iters,
                                     objective_scale, chains, swap_interval)
    _metrics.note_result(result, engine=engine)
    return result


def _scale_for(ev, objective_scale: Optional[float]) -> float:
    # Normalise temperature to the objective magnitude so the paper's
    # (K_start=1000, K_min=1) schedule behaves identically across objectives
    # whose absolute scales differ by orders of magnitude.
    if objective_scale is not None:
        return objective_scale
    return max(abs(ev.objective), 1e-12) / 1000.0


def _optimise_single(problem, seed, k_start, k_min, cooling, time_budget_s,
                     max_iters, objective_scale) -> OptimResult:
    rng = random.Random(seed)
    graph, backend, platform = problem.graph, problem.backend, problem.platform

    v = repair(problem, backend.initial(graph))
    ev = problem.evaluate(v)
    best_v, best_ev = v, ev
    history = [(0, ev.objective)]
    scale = _scale_for(ev, objective_scale)

    K = k_start
    it = 0
    start = time.perf_counter()
    while True:
        it += 1
        v_prev, ev_prev = v, ev
        v = backend.random_move(rng, graph, v, platform)
        ev = problem.evaluate(v)
        accept = False
        if ev.feasible:
            delta = (ev_prev.objective - ev.objective) / scale
            psi = math.exp(min(0.0, delta / K))
            accept = psi >= rng.random()
        if ev.feasible and not best_ev.feasible:
            # any feasible evaluation (even a rejected one) beats an
            # infeasible incumbent — the optimiser must never return an
            # infeasible design when a feasible point was visited
            best_v, best_ev = v, ev
            history.append((it, ev.objective))
        if not accept:
            v, ev = v_prev, ev_prev             # reject new design
        elif ev.objective < best_ev.objective:
            best_v, best_ev = v, ev
            history.append((it, ev.objective))
        if K > k_min:
            K = max(k_min, K * cooling)
            if K == k_min and time_budget_s is None and max_iters is None:
                break
        else:
            if time_budget_s is None and max_iters is None:
                break
        if max_iters is not None and it >= max_iters:
            break
        if time_budget_s is not None and \
                time.perf_counter() - start > time_budget_s:
            break

    elapsed = time.perf_counter() - start
    return OptimResult(best_v, best_ev, it, elapsed, history, name="annealing")


# ----------------------------------------------------------------------
# parallel tempering (chains=K): one batched evaluate per sweep
# ----------------------------------------------------------------------

def _optimise_tempering(problem, seed, k_start, k_min, cooling,
                        time_budget_s, max_iters, objective_scale,
                        chains, swap_interval) -> OptimResult:
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    rngs = [random.Random(seed * 1_000_003 + c) for c in range(chains)]
    swap_rng = random.Random(seed * 1_000_003 + 999_983)

    v0 = repair(problem, backend.initial(graph))
    ev0 = problem.evaluate(v0)
    vs: List[Variables] = [v0] * chains
    objs = [ev0.objective] * chains
    best_v, best_obj, best_feas = v0, ev0.objective, ev0.feasible
    history = [(0, ev0.objective)]
    scale = _scale_for(ev0, objective_scale)

    # geometric ladder: chain 0 runs the paper's schedule, higher chains run
    # hotter replicas of it; all cool in lockstep with floor k_min.
    temps = [k_start * (LADDER_SPREAD ** c) for c in range(chains)]
    bev = problem.batched()

    it = 0                       # design points evaluated (all chains)
    sweep = 0
    start = time.perf_counter()
    stop = False
    while not stop:
        sweep += 1
        props = [backend.random_move(rngs[c], graph, vs[c], platform)
                 for c in range(chains)]
        res = bev.evaluate_batch(*bev.pack(props))
        problem.note_batch_evals(chains)
        it += chains
        for c in range(chains):
            c_feas = bool(res.feasible[c])
            c_obj = float(res.objective[c])
            if c_feas:
                delta = (objs[c] - c_obj) / scale
                psi = math.exp(min(0.0, delta / temps[c]))
                if psi >= rngs[c].random():
                    vs[c], objs[c] = props[c], c_obj
            if incumbent_better(c_feas, c_obj, best_feas, best_obj):
                best_v, best_obj, best_feas = props[c], c_obj, c_feas
                history.append((it, c_obj))

        if swap_interval and sweep % swap_interval == 0:
            for c in range(chains - 1):
                # Metropolis replica exchange between adjacent temperatures:
                # accept with min(1, exp((1/T_c - 1/T_c+1)(E_c - E_c+1)/scale))
                d = (1.0 / temps[c] - 1.0 / temps[c + 1]) \
                    * (objs[c] - objs[c + 1]) / scale
                if d >= 0 or math.exp(d) >= swap_rng.random():
                    vs[c], vs[c + 1] = vs[c + 1], vs[c]
                    objs[c], objs[c + 1] = objs[c + 1], objs[c]

        cold = temps[0]
        if cold > k_min:
            temps = [max(k_min, t * cooling) for t in temps]
            if temps[0] == k_min and time_budget_s is None \
                    and max_iters is None:
                stop = True
        elif time_budget_s is None and max_iters is None:
            stop = True
        if max_iters is not None and it >= max_iters:
            stop = True
        if time_budget_s is not None and \
                time.perf_counter() - start > time_budget_s:
            stop = True

    elapsed = time.perf_counter() - start
    best_eval = problem.evaluate(best_v)
    return OptimResult(best_v, best_eval, it, elapsed, history,
                       name=f"annealing-pt{chains}")


# ----------------------------------------------------------------------
# device-resident multi-chain SA (engine="torch")
# ----------------------------------------------------------------------

def _optimise_torch(problem, seed, k_start, k_min, cooling, time_budget_s,
                    max_iters, objective_scale, chains,
                    device=None) -> OptimResult:
    import numpy as np
    import torch

    from repro_torch.core.accel.search_loops import DeviceSA
    from repro_torch.core.optimizers.common import incumbent_better

    sa = DeviceSA(problem, device=device)

    v0 = repair(problem, problem.backend.initial(problem.graph))
    ev0 = problem.evaluate(v0)
    scale = _scale_for(ev0, objective_scale)
    temps = torch.tensor([k_start * (LADDER_SPREAD ** c)
                          for c in range(chains)],
                         dtype=sa.A.flops.dtype, device=sa.device)
    state = sa.init_state(v0, ev0, chains, seed)
    history = [(0, ev0.objective)]

    if max_iters is not None:
        total_sweeps = max(1, -(-max_iters // chains))
    else:
        # cool the cold chain from k_start to k_min, like the host schedule
        total_sweeps = max(1, math.ceil(math.log(k_min / k_start)
                                        / math.log(cooling)))

    start = time.perf_counter()
    sweeps = 0
    g_best, g_feas = ev0.objective, ev0.feasible
    while True:
        # max_iters always caps the sweep count; a time budget keeps
        # running at the K_min floor until the clock expires (host
        # contract) and needs 128-sweep blocks so the clock is actually
        # checked. Without a time budget the WHOLE schedule is one block,
        # and the block's traces are its one readback.
        if time_budget_s is not None:
            chunk = 128 if max_iters is None \
                else min(128, total_sweeps - sweeps)
        else:
            chunk = total_sweeps - sweeps
        if chunk <= 0:
            break
        state, temps, (t_obj, t_feas) = sa.run(state, temps, scale,
                                               cooling, k_min, chunk)
        traces = torch.stack([t_obj.to(torch.float64),
                              t_feas.to(torch.float64)]).cpu().numpy()
        t_obj, t_feas = traces[0], traces[1].astype(bool)
        for t in range(chunk):
            # feasibility-aware best across chains after this sweep
            row_f = t_feas[t]
            if row_f.any():
                c = int(np.argmin(np.where(row_f, t_obj[t], np.inf)))
            else:
                c = int(np.argmin(t_obj[t]))
            if incumbent_better(bool(row_f[c]), float(t_obj[t, c]),
                                g_feas, g_best):
                g_best, g_feas = float(t_obj[t, c]), bool(row_f[c])
                history.append(((sweeps + t + 1) * chains, g_best))
        sweeps += chunk
        if time_budget_s is not None:
            if time.perf_counter() - start > time_budget_s:
                break
        elif sweeps >= total_sweeps:
            break

    elapsed = time.perf_counter() - start
    best_v, best_obj, best_feas = None, np.inf, False
    for v, o, f in sa.best_variables(state):
        if best_v is None or incumbent_better(f, o, best_feas, best_obj):
            best_v, best_obj, best_feas = v, o, f
    best_eval = problem.evaluate(best_v)
    problem.note_batch_evals(sweeps * chains)
    return OptimResult(best_v, best_eval, sweeps * chains, elapsed, history,
                       name=f"annealing-torch{chains}")
