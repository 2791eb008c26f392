"""Brute-Force optimiser (paper §IV-B).

Enumerates all combinations of fold values over the backend's independent
decision slots (and optionally cut sets), discards constraint violators, and
keeps the best objective. Guarantees the optimum at enumeration cost — the
Table-IV benchmark uses the measured points/s to extrapolate full-space time.

Three engines (``core/accel`` registry; ``batched`` is an alias for
``numpy`` and ``auto`` for ``torch``):
  torch (default) — candidate construction (mixed-radix digit decode
      through precomputed propagation tables) AND evaluation run on the
      card, one chunk at a time (``core/accel/search_loops.py``); cut sets
      with a cut take the segred kernel for the partition times. Same
      enumeration order, same optimum and history as the numpy engine
      (the recorded objective values are float32; float64 is reachable
      only through ``search_loops.brute_force_torch(dtype=...)``, for
      tests). ``device="cpu"`` runs it on the CPU with the kernel's plain
      version.
  numpy — the product space is enumerated in chunked batches
      (``batch_size`` points per call) through the vectorised
      ``core/batched_eval.py`` array program. Candidate construction mirrors
      the scalar ``backend.set_fold`` + ``propagate`` semantics exactly
      (clamp tables + vectorised propagation), so the enumerated set — and
      hence the returned optimum and improvement history — is identical to
      the scalar engine's.
  scalar — the original one-point-at-a-time reference path, kept for
      equivalence tests and the Table-IV speedup baseline.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hdgraph import HDGraph, Variables
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers.common import OptimResult
from repro_torch.obs import metrics as _metrics

_DIM_ATTR = {"s_in": "rows", "s_out": "col_div", "kern": "batch"}


def optimise(problem: Problem,
             include_cuts: bool = False,
             max_cuts: int = 1,
             max_points: Optional[int] = None,
             time_budget_s: Optional[float] = None,
             engine: str = "torch",
             batch_size: int = 4096,
             devices: Optional[int] = None,
             device=None) -> OptimResult:
    from repro_torch.core.accel import resolve_engine
    engine = resolve_engine(engine)
    if devices is not None:
        raise NotImplementedError(
            f"devices={devices}: sharded chunk enumeration is not ported to "
            f"torch yet (ROADMAP Queue 1, item 9)")
    if engine != "torch" and device is not None:
        raise ValueError(f"device= applies to the torch engine only; "
                         f"engine resolved to {engine!r}")
    if engine == "scalar":
        result = _optimise_scalar(problem, include_cuts, max_cuts,
                                  max_points, time_budget_s)
    elif engine == "torch":
        from repro_torch.core.accel.search_loops import brute_force_torch
        result = brute_force_torch(problem, include_cuts, max_cuts,
                                   max_points, time_budget_s, batch_size,
                                   device=device)
    else:
        result = _optimise_batched(problem, include_cuts, max_cuts,
                                   max_points, time_budget_s, batch_size)
    _metrics.note_result(result, engine=engine)
    return result


def _cut_sets(cut_edges, include_cuts: bool, max_cuts: int):
    yield ()
    if include_cuts:
        for r in range(1, max_cuts + 1):
            yield from itertools.combinations(cut_edges, r)


# ----------------------------------------------------------------------
# batched engine
# ----------------------------------------------------------------------

def _clamp(value: int, dim: int) -> int:
    """set_fold's divisor clamp: walk down to the nearest divisor of dim."""
    while value > 1 and dim % value != 0:
        value -= 1
    return value


def _slot_scopes(backend, graph: HDGraph, slots, cuts):
    """Cut-aware write scopes per slot, mirroring ``Backend.set_fold``
    (including the decode split-KV skip for globally-tied s_in)."""
    scopes = []
    for i, var in slots:
        sc = backend.scope(graph, i, var, cuts)
        if var == "s_in" and backend.granularity["s_in"] == "global":
            sc = [j for j in sc if not graph.nodes[j].internal_rows]
        scopes.append(sc)
    return scopes


def _clamp_tables(graph: HDGraph, slots, scopes, menus):
    """clamp_tab[slot][node] = menu-index -> clamped fold value."""
    tabs: List[Dict[int, np.ndarray]] = []
    for s, (i, var) in enumerate(slots):
        per_node: Dict[int, np.ndarray] = {}
        for j in scopes[s]:
            dim = getattr(graph.nodes[j], _DIM_ATTR[var])
            per_node[j] = np.array([_clamp(val, dim) for val in menus[s]],
                                   np.int64)
        tabs.append(per_node)
    return tabs


def _propagate_batch(backend, graph: HDGraph, cuts, si, so, kk) -> None:
    """Vectorised ``Backend.propagate`` for a FIXED cut set (in place)."""
    n = len(graph.nodes)
    bounds = [0] + [c + 1 for c in sorted(cuts)] + [n]
    if backend.scan_tying:
        for b in range(len(bounds) - 1):
            anchors = {}
            for j in range(bounds[b], bounds[b + 1]):
                g = graph.nodes[j].scan_group
                if g < 0:
                    continue
                if g not in anchors:
                    anchors[g] = (si[:, j].copy(), so[:, j].copy(),
                                  kk[:, j].copy())
                else:
                    si[:, j], so[:, j], kk[:, j] = anchors[g]
    if backend.intra_matching:
        for j, node in enumerate(graph.nodes):
            if node.elementwise:
                so[:, j] = si[:, j]
    if backend.inter_matching:
        for b in range(len(bounds) - 1):
            part = range(bounds[b], bounds[b + 1])
            aj = next((j for j in part if not graph.nodes[j].internal_rows),
                      None)
            anchor_si = (si[:, aj].copy() if aj is not None
                         else np.ones(si.shape[0], np.int64))
            anchor_k = kk[:, part[0]].copy()
            for j in part:
                node = graph.nodes[j]
                kk[:, j] = np.where(node.batch % anchor_k == 0, anchor_k, 1)
                if not node.internal_rows:
                    si[:, j] = np.where(node.rows % anchor_si == 0,
                                        anchor_si, 1)
                if node.elementwise and backend.intra_matching:
                    so[:, j] = si[:, j]


def _optimise_batched(problem, include_cuts, max_cuts, max_points,
                      time_budget_s, batch_size) -> OptimResult:
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    slots, menus = backend.space(graph, platform)
    sizes = [len(m) for m in menus]
    strides = [1] * len(slots)                    # itertools.product order:
    for s in range(len(slots) - 2, -1, -1):       # last slot varies fastest
        strides[s] = strides[s + 1] * sizes[s + 1]
    total = 1
    for s in sizes:
        total *= s

    base = backend.initial(graph).with_cuts(())
    n = len(graph.nodes)
    base_si = np.array(base.s_in, np.int64)
    base_so = np.array(base.s_out, np.int64)
    base_kk = np.array(base.kern, np.int64)
    bev = problem.batched()

    best_v: Optional[Variables] = None
    best_obj = np.inf
    points = 0
    history: List[Tuple[int, float]] = []
    start = time.perf_counter()
    stop = False

    # Candidate blocks accumulate ACROSS cut sets until a chunk is full, so
    # tiny per-cut-set spaces (e.g. the simple backend) still evaluate in
    # large batches. Enumeration order — and hence the returned optimum and
    # history — stays identical to the scalar engine.
    blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    buffered = 0

    def flush():
        nonlocal buffered, best_obj, best_v, points, stop
        if not buffered:
            return
        if len(blocks) == 1:
            si, so, kk, cb = blocks[0]
        else:
            si, so, kk, cb = (np.concatenate([b[x] for b in blocks])
                              for x in range(4))
        blocks.clear()
        buffered = 0
        res = bev.evaluate_batch(si, so, kk, cb)
        problem.note_batch_evals(len(res))
        objs = np.where(res.feasible, res.objective, np.inf)
        # exact scalar-engine history: every strict improvement over the
        # running best, in enumeration order
        prefix = np.minimum.accumulate(
            np.concatenate(([best_obj], objs)))[:-1]
        imp = np.nonzero(objs < prefix)[0]
        for r in imp:
            history.append((points + int(r) + 1, float(objs[r])))
        if len(imp):
            r = int(imp[-1])
            best_obj = float(objs[r])
            best_v = bev.unpack_row(si, so, kk, cb, r)
        points += len(res)
        if max_points is not None and points >= max_points:
            stop = True
        if time_budget_s is not None and \
                time.perf_counter() - start > time_budget_s:
            stop = True

    for cuts in _cut_sets(graph.cut_edges, include_cuts, max_cuts):
        if stop:
            break
        scopes = _slot_scopes(backend, graph, slots, cuts)
        tabs = _clamp_tables(graph, slots, scopes, menus)
        cb_row = np.zeros(max(n - 1, 0), bool)
        for c in cuts:
            cb_row[c] = True
        produced = 0
        while produced < total:
            take = min(batch_size - buffered, total - produced)
            if max_points is not None:
                take = min(take, max_points - points - buffered)
            if take <= 0:
                stop = True
                break
            off = np.arange(take)
            si = np.tile(base_si, (take, 1))
            so = np.tile(base_so, (take, 1))
            kk = np.tile(base_kk, (take, 1))
            arrays = {"s_in": si, "s_out": so, "kern": kk}
            for s, (i, var) in enumerate(slots):
                # digit of (produced + off) in the mixed-radix space. Stride
                # and global index are Python ints (design spaces routinely
                # exceed 2^63), so reduce them BEFORE touching int64 arrays.
                stride, size = strides[s], sizes[s]
                if stride >= take:
                    # slow slot: at most one digit boundary inside the chunk
                    q, r = divmod(produced, stride)
                    carry_at = min(stride - r, take + 1)
                    digit = ((q % size) + (off >= carry_at)) % size
                else:
                    # fast slot: stride*size is small; the digit is periodic
                    base = produced % (stride * size)
                    digit = ((base + off) // stride) % size
                arr = arrays[var]
                for j, tab in tabs[s].items():
                    arr[:, j] = tab[digit]
            _propagate_batch(backend, graph, cuts, si, so, kk)
            blocks.append((si, so, kk, np.tile(cb_row, (take, 1))))
            buffered += take
            produced += take
            if buffered >= batch_size:
                flush()
                if stop:
                    break
    flush()

    elapsed = time.perf_counter() - start
    if best_v is None:                         # no feasible point found
        best_v = backend.initial(graph)
    best_eval = problem.evaluate(best_v)
    return OptimResult(best_v, best_eval, points, elapsed, history,
                       name="brute_force")


# ----------------------------------------------------------------------
# scalar reference engine (the original one-at-a-time path)
# ----------------------------------------------------------------------

def _optimise_scalar(problem, include_cuts, max_cuts, max_points,
                     time_budget_s) -> OptimResult:
    graph, backend, platform = problem.graph, problem.backend, problem.platform
    slots, menus = backend.space(graph, platform)

    base = backend.initial(graph).with_cuts(())
    best_v, best_eval = None, None
    points = 0
    start = time.perf_counter()
    history = []
    stop = False

    for cuts in _cut_sets(graph.cut_edges, include_cuts, max_cuts):
        if stop:
            break
        for assignment in itertools.product(*menus):
            v = base.with_cuts(cuts)
            for (i, var), value in zip(slots, assignment):
                v = backend.set_fold(graph, v, i, var, value)
            ev = problem.evaluate(v)
            points += 1
            if ev.feasible and (best_eval is None
                                or ev.objective < best_eval.objective):
                best_v, best_eval = v, ev
                history.append((points, ev.objective))
            if max_points is not None and points >= max_points:
                stop = True
                break
            if time_budget_s is not None and \
                    time.perf_counter() - start > time_budget_s:
                stop = True
                break

    elapsed = time.perf_counter() - start
    if best_eval is None:                      # no feasible point found
        v = backend.initial(graph)
        best_v, best_eval = v, problem.evaluate(v)
    return OptimResult(best_v, best_eval, points, elapsed, history,
                       name="brute_force")
