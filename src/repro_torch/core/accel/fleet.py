"""Fleet sweeps: one device pass searches MANY problems at once (the port
of ``repro.core.accel.fleet``).

SAMO's headline tables sweep the optimiser across many model/platform
pairs. The per-problem engine (``search_loops.py``) runs one Problem at a
time; this module runs a whole portfolio as a few device programs:

  1. **Bucketing** — problems whose program-shaping configuration matches
     (mode, backend rules, ModelOptions; see ``StaticSpec``) share a
     bucket. Platform limits, bandwidths, fold-realisability cubes, the
     Eq. 5 objective selector and the Eq. 4 amortisation factor are
     ``DeviceTensors`` data, so a bucket may mix target platforms AND
     objectives. Within a bucket every per-problem constant is padded to
     a common shape — node count, decision-slot count, menu radix,
     scan-pair count, fold-cube size — with neutral values that cannot
     change any result (``lowering.py`` states the padding contract).

  2. **Stacking** — the padded ``DeviceTensors`` (platform scalars
     included) and, for SA and rule-based, the move tables and chain
     states are stacked along a leading problem ("lane") axis.

  3. **Lanes** — the *same* bodies the per-problem engine runs
     (``_bf_chunk_core``, ``_sa_sweeps``, ``_rb_descend_core``) take the
     lane axis as their leading axis: one step, sweep or chunk of the
     whole bucket is one pass of eager device work and ONE segred launch
     (two for a rule-based step), whatever the number of lanes (K1 reduces each row on its own, so the
     lanes fold into its rows). The bodies' float sums are order-fixed
     (``eval_torch.py``), each lane draws its own random stream, and
     padding is bitwise neutral, so the fleet returns per-problem optima,
     objectives and improvement histories IDENTICAL to looping the
     per-problem torch engine. A lane whose descent has converged, or
     that has no request this round (``cap == 0``), is carried through a
     step unchanged by an explicit ``torch.where``.

Entry points mirror the single-problem optimisers and return one
``OptimResult`` per problem, in input order:

    fleet_brute_force(problems, include_cuts=..., batch_size=...)
    fleet_annealing(problems, seed=..., chains=..., max_iters=...)
    fleet_rule_based(problems, multi_start=...)

Each runs on ``device`` (default: the card; ``device="cpu"`` runs the
kernel's plain version). ``devices=D`` splits each bucket's lanes, padded
up to a multiple of D (``_pad_lanes``), into D contiguous slices, one a
shard of ``runtime.device_mesh(D, device)``; each slice runs the unchanged
bucket program on its shard's device, every shard launched before the
step's readback, and the padding lanes are dropped on the host. Lanes
never interact and a lane's bits do not depend on how many lanes share a
call, so the results are bitwise those of ``devices=None`` for any D. On
one card the shards run one after another; on several, on separate cards.
``core.pipeline.optimise_portfolio`` wraps these behind the engine
registry. The host helpers (bucketing, padding sizes, lane padding, the
brute-force member state) are copied from the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accel.eval_torch import TorchEvaluator
from repro_torch.core.accel.lowering import DeviceTensors, stack_tensors
from repro_torch.core.accel.search_loops import (
    DeviceRuleBased,
    DeviceSA,
    _bf_chunk_core,
    _construction_tables,
    _pow2ceil,
    _rb_descend_core,
    _sa_sweeps,
    absorb_improvements,
    build_sa_tables,
    chunk_descriptor,
)
from repro_torch.core.hdgraph import Variables
from repro_torch.core.optimizers.common import (
    OptimResult,
    incumbent_better,
    repair,
)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["fleet_brute_force", "fleet_annealing", "fleet_rule_based",
           "bucket_indices", "bucket_key"]


def _fleet_mesh(devices: Optional[int], device):
    """Resolve the ``devices`` kwarg shared by the fleet entry points:
    ``None`` keeps the unsharded bucket program; an int D gives the D
    shards' devices (``runtime.device_mesh``), the bucket being built on
    the first. Returns ``(mesh_or_None, D, the device to build on)``."""
    if devices is None:
        return None, 1, device
    from repro_torch.runtime import device_mesh
    mesh = device_mesh(devices, device)
    return mesh, len(mesh), mesh[0]


def _pad_lanes(P: int, D: int) -> int:
    """Bucket lane count padded up so the ``dev`` axis divides it: ragged
    device counts ride on no-op lanes (``take=0`` for brute force,
    ``cap=0`` for rule-based, a duplicated lane otherwise — all discarded
    on the host side), the same inert-lane contract the fleets already
    use for members that run out of work."""
    return -(-P // D) * D


def _shards(mesh, P_pad: int, *stacks) -> list:
    """``(device, lo, hi, slices)`` of each shard: lanes ``[lo, hi)`` of
    every lane-stacked tensor or ``DeviceTensors`` in ``stacks``, on the
    shard's device (views when the device is theirs already)."""
    Pl = P_pad // len(mesh)
    on = lambda x, lo, dev: (
        DeviceTensors(*(f[lo:lo + Pl].to(dev) for f in x))
        if isinstance(x, DeviceTensors) else x[lo:lo + Pl].to(dev))
    return [(dev, d * Pl, (d + 1) * Pl,
             tuple(on(x, d * Pl, dev) for x in stacks))
            for d, dev in enumerate(mesh)]


def _gather_lanes(outs) -> list:
    """The shards' outputs (tuples of [Pl, ...] tensors) read back and
    joined along the lane axis, as numpy arrays."""
    return [np.concatenate([o[i].cpu().numpy() for o in outs])
            for i in range(len(outs[0]))]


def _same_program(members, what: str) -> None:
    """Every member of a bucket must share one program shape."""
    first = members[0]
    for m in members[1:]:
        if (m.static, getattr(m, "gran", None)) != \
                (first.static, getattr(first, "gran", None)):
            raise RuntimeError(f"{what}: bucketed problems must share a "
                               f"StaticSpec")


#: node counts round up to the next multiple of this before bucketing, so
#: nearly-equal graphs share one executable while a 35-node outlier never
#: forces 2-3x padding waste onto an 11-node majority
NODE_TIER = 4

def _node_tier(n: int) -> int:
    return -(-n // NODE_TIER) * NODE_TIER

def _platform_pads(problems) -> Tuple[int, int]:
    """(pad_vals, pad_lut) covering every member platform's fold menu, so
    a heterogeneous bucket's realisability cubes and value luts stack
    (lowering.py pads them bit-neutrally: False / -1 fill)."""
    menus = [p.platform.fold_values() for p in problems]
    return (max(len(m) for m in menus),
            max(m[-1] for m in menus) + 2)

def _bucket_key(problem, tiered: bool) -> tuple:
    """Problems with equal keys share one StaticSpec (padded node count
    included via the size tier when ``tiered``) and hence one fleet
    executable.

    The key holds ONLY trace-shaping structure: mode/exec-model, backend
    rule flags, ModelOptions, and the node-size tier. Platform identity is
    deliberately absent — resource limits, bandwidths and the fold cube
    are ``DeviceArrays`` data, so problems targeting different platforms
    stack into one bucket (heterogeneous-platform fleets). The objective
    and ``batch_amortisation`` are likewise absent since PR 5 (they are
    ``DeviceArrays.obj_latency`` / ``.batch_amortisation``): a bucket may
    mix latency- and throughput-objective problems and still share one
    executable.
    """
    b = problem.backend
    return (problem.graph.mode, problem.exec_model, b.name, b.strict_kv,
            b.intra_matching, b.inter_matching, b.scan_tying,
            tuple(sorted(b.granularity.items())), b.fixed_unity,
            dataclasses.astuple(problem.opts),
            bool(problem.graph.cut_edges),
            _node_tier(len(problem.graph.nodes)) if tiered else 0)

def bucket_key(problem, tiered: bool = False) -> tuple:
    """Public trace-signature key: problems with equal keys share one
    ``StaticSpec`` and hence one fleet executable (``_bucket_key``
    documents exactly what the key holds and why platform/objective are
    absent). ``tiered=False`` matches the rule-based/SA fleets, which is
    also what the service admission queue (``repro/service/queue.py``)
    buckets incoming requests by: requests with equal untiered keys can
    join the same in-flight lockstep round as late-joiner lanes."""
    return _bucket_key(problem, tiered)

def bucket_indices(problems, tiered: bool = True) -> List[List[int]]:
    """Group problem indices into fleet buckets (stable order).

    ``tiered`` splits buckets by node-count tier. Brute force is
    compute-bound over [B, n] chunks, so padding an 11-node graph to a
    35-node outlier costs real throughput — it buckets tiered. The SA
    sweep's arrays are chain-sized (tiny); its cost is the op count of the
    scan body, so ONE executable for the whole portfolio beats several
    tier compiles — it buckets untiered.

    Worked example — a Table-IV-style portfolio of six problems::

        idx  graph          nodes  backend   platform       mode
        0    tinyllama      11     spmd      mesh-4x4       train
        1    llama3.2       11     spmd      abstract-16    train
        2    stablelm       12     spmd      mesh-4x4       train
        3    tinyllama      11     megatron  mesh-4x4       train
        4    jamba          35     spmd      mesh-4x4       train
        5    tinyllama      11     spmd      mesh-2x8       decode

    With ``tiered=True`` (brute force, NODE_TIER=4) the buckets are
    ``[[0, 1, 2], [3], [4], [5]]``:

    * 0, 1 and 2 share backend rules, mode and node tier (11 rounds up
      to 12) — their three *platforms'* differing limit scalars and fold
      cubes are stacked data, not separate executables;
    * 3 splits on backend rule flags (megatron vs spmd shapes the trace:
      different matching/tying branches);
    * 4 splits on node tier (36 vs 12 — padding everyone to 35 nodes
      would tax the whole bucket's chunk throughput);
    * 5 splits on mode (decode changes the traced row arithmetic).

    With ``tiered=False`` (SA) the node tier is dropped, so 4 joins
    ``[0, 1, 2, 4]`` — the sweep pads its node axis bit-neutrally and the
    chain-shaped arrays don't care about graph size.
    """
    byk = {}
    for i, p in enumerate(problems):
        byk.setdefault(_bucket_key(p, tiered), []).append(i)
    return list(byk.values())


def _to(device):
    """numpy -> a tensor on ``device``."""
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ----------------------------------------------------------------------
# brute force
# ----------------------------------------------------------------------

class _BFMember:
    """Host-side per-problem enumeration state inside one bucket."""

    def __init__(self, index: int, problem, include_cuts: bool,
                 max_cuts: int):
        from repro_torch.core.optimizers.brute_force import _cut_sets
        self.index = index
        self.problem = problem
        self.graph = problem.graph
        self.backend = problem.backend
        self.slots, self.menus = self.backend.space(self.graph,
                                                    problem.platform)
        self.sizes = [len(m) for m in self.menus]
        self.strides = [1] * len(self.slots)
        for s in range(len(self.slots) - 2, -1, -1):
            self.strides[s] = self.strides[s + 1] * self.sizes[s + 1]
        self.total = 1
        for s in self.sizes:
            self.total *= s
        self.max_menu = max(self.sizes, default=1)
        self.n = len(self.graph.nodes)
        self.base = self.backend.initial(self.graph).with_cuts(())
        self.cut_sets = list(_cut_sets(self.graph.cut_edges, include_cuts,
                                       max_cuts))
        # search state; ``planned`` runs ahead of ``points`` by the chunks
        # still in flight (the chunk loop is software-pipelined)
        self.best_v: Optional[Variables] = None
        self.best_obj = np.inf
        self.points = 0
        self.planned = 0
        self.history: List[Tuple[int, float]] = []
        self.stopped = False

    def tables_for(self, k: int, n_pad: int, s_pad: int, mm_pad: int, idt):
        """Padded (sigma, T, cb_row) for this member's k-th cut set, or
        inert tables when the member has no k-th cut set."""
        E = max(n_pad - 1, 0)
        if k >= len(self.cut_sets):
            return (np.full((3, n_pad), s_pad, idt),
                    np.ones((3, n_pad, mm_pad), idt),
                    np.zeros(E, bool), None)
        from repro_torch.core.optimizers.brute_force import (
            _clamp_tables,
            _slot_scopes,
        )
        cuts = self.cut_sets[k]
        scopes = _slot_scopes(self.backend, self.graph, self.slots, cuts)
        tabs = _clamp_tables(self.graph, self.slots, scopes, self.menus)
        sigma, T = _construction_tables(self.graph, self.backend,
                                        self.slots, scopes, tabs,
                                        self.menus, cuts, self.base,
                                        self.max_menu, idt)
        S = len(self.slots)
        sig = np.full((3, n_pad), s_pad, idt)
        sig[:, :self.n] = np.where(sigma == S, s_pad, sigma)
        Tp = np.ones((3, n_pad, mm_pad), idt)
        Tp[:, :self.n, :self.max_menu] = T
        cb_row = np.zeros(E, bool)
        for c in cuts:
            cb_row[c] = True
        return sig, Tp, cb_row, cuts

    def descriptor(self, produced: int, take: int, s_pad: int, idt):
        """Chunk descriptor rows (shared helper; padded slots -> digit 0)."""
        return chunk_descriptor(self.strides, self.sizes, produced, take,
                                s_pad, idt)

    def absorb(self, objs: np.ndarray, bi_si, bi_so, bi_kk,
               cb_row: np.ndarray, take: int) -> None:
        """Identical improvement bookkeeping to the per-problem engine
        (same shared helper)."""
        objs = np.asarray(objs[:take], np.float64)
        if _trace.enabled():
            _metrics.histogram("accel.fleet_bf.feasible_fraction").observe(
                float(np.isfinite(objs).mean()) if take else 0.0)
        self.problem.note_batch_evals(take)
        last_imp, self.best_obj = absorb_improvements(
            objs, self.best_obj, self.points, self.history)
        if last_imp is not None:
            n = self.n
            self.best_v = Variables(
                tuple(int(e) for e in np.nonzero(cb_row[:max(n - 1, 0)])[0]),
                tuple(int(x) for x in np.asarray(bi_si)[:n]),
                tuple(int(x) for x in np.asarray(bi_so)[:n]),
                tuple(int(x) for x in np.asarray(bi_kk)[:n]))
        self.points += take

    def result(self, elapsed: float) -> OptimResult:
        best_v = self.best_v
        if best_v is None:                     # no feasible point found
            best_v = self.backend.initial(self.graph)
        best_eval = self.problem.evaluate(best_v)
        return OptimResult(best_v, best_eval, self.points, elapsed,
                           self.history, name="brute_force")


@torch.no_grad()
def fleet_brute_force(problems: Sequence, include_cuts: bool = False,
                      max_cuts: int = 1, max_points: Optional[int] = None,
                      batch_size: int = 4096,
                      devices: Optional[int] = None,
                      device=None) -> List[OptimResult]:
    """Multi-problem brute force, one chunk of every member a step.

    Per-problem results (optimum design, objective, point count and
    improvement history) are identical to calling
    ``brute_force(problem, engine="torch", ...)`` in a loop; ``max_points``
    applies per problem. Problems are grouped into buckets (tiered by node
    count) and each bucket's chunks run in lockstep across its members: a
    member with no chunk left rides along as a ``take = 0`` lane, and one
    with no k-th cut set as an inert lane. Chunk j + 1 is dispatched
    before chunk j is read back. Each result's ``seconds`` is its
    BUCKET's wall time (members search simultaneously — per-problem times
    don't sum). The empty cut set is one partition and takes no segmented
    reduction; every chunk of a cut set with a cut takes one segred launch
    for the whole bucket (one a shard under ``devices=D``, whose ragged
    lane counts pad with ``take = 0`` lanes).
    """
    mesh, D, device = _fleet_mesh(devices, device)
    results: List[Optional[OptimResult]] = [None] * len(problems)
    with _trace.span("fleet.bucketing", problems=len(problems),
                     optimiser="brute_force") as bsp:
        buckets = bucket_indices(problems)
        bsp.set(buckets=len(buckets))
    for bi, idxs in enumerate(buckets):
        # the bucket span is the members' shared wall clock (see the
        # ``seconds`` note in the docstring) — recorded when tracing is
        # on, but always timing
        bucket_sp = _trace.span("fleet.bf.bucket", bucket=bi,
                                members=len(idxs))
        bucket_sp.__enter__()
        members = [_BFMember(i, problems[i], include_cuts, max_cuts)
                   for i in idxs]
        n_pad = max(m.n for m in members)
        s_pad = max(len(m.slots) for m in members)
        mm_pad = max(m.max_menu for m in members)
        pairs_pad = max(
            (len(m.problem.batched().scan_pairs) for m in members),
            default=0) or 1
        vals_pad, lut_pad = _platform_pads(m.problem for m in members)
        tevs = [TorchEvaluator.from_problem(m.problem, device=device,
                                            pad_nodes=n_pad,
                                            pad_pairs=pairs_pad,
                                            pad_vals=vals_pad,
                                            pad_lut=lut_pad)
                for m in members]
        _same_program(tevs, "fleet_brute_force")
        static = tevs[0].static
        t = _to(tevs[0].device)
        P = len(members)
        P_pad = _pad_lanes(P, D)
        A = stack_tensors([tv.arrays for tv in tevs]
                          + [tevs[0].arrays] * (P_pad - P))
        idt = np.int64                            # A's integers are int64
        B = min(batch_size, _pow2ceil(max(m.total for m in members)))

        def absorb(entry):
            outs, takes_np, cb_np_k = entry
            # blocking readback: this span, not the async chunk dispatch,
            # absorbs the device compute time
            with _trace.span("fleet.d2h.bf_chunk"):
                objs, bi_si, bi_so, bi_kk = _gather_lanes(outs)
            for mi, m in enumerate(members):
                take = int(takes_np[mi])
                if take > 0:
                    m.absorb(objs[mi], bi_si[mi], bi_so[mi], bi_kk[mi],
                             cb_np_k[mi], take)

        K = max(len(m.cut_sets) for m in members)
        for k in range(K):
            tables = [m.tables_for(k, n_pad, s_pad, mm_pad, idt)
                      for m in members]
            # no-op lanes padding P up to a multiple of the shard count
            # reuse the inert-tables shape (take stays 0 for them)
            tables += [(np.full((3, n_pad), s_pad, idt),
                        np.ones((3, n_pad, mm_pad), idt),
                        np.zeros(max(n_pad - 1, 0), bool), None)
                       ] * (P_pad - P)
            sigma_d = t(np.stack([tb[0] for tb in tables]))
            T_d = t(np.stack([tb[1] for tb in tables]))
            cb_np = np.stack([tb[2] for tb in tables])
            cb_d = t(cb_np)
            if mesh is not None:
                shards = _shards(mesh, P_pad, A, sigma_d, T_d, cb_d)
            max_parts = 1 + max(len(tb[3]) for tb in tables
                                if tb[3] is not None)
            active = [tb[3] is not None and not m.stopped
                      for m, tb in zip(members, tables)]
            produced = [0] * len(members)
            # 1-deep software pipeline: dispatch chunk j+1 before blocking
            # on chunk j's results, so host bookkeeping overlaps device
            # compute. ``planned`` (not ``points``) drives the budget math
            # and matches the per-problem loop's accounting exactly.
            pending: List[tuple] = []
            while True:
                takes = np.zeros(P_pad, np.int64)
                descs = np.zeros((P_pad, s_pad, 4), idt)
                descs[:, :, 0] = 1
                descs[:, :, 2] = 1
                descs[:, :, 3] = 1
                for mi, m in enumerate(members):
                    if not active[mi] or m.stopped:
                        continue
                    take = min(B, m.total - produced[mi])
                    if max_points is not None:
                        take = min(take, max_points - m.planned)
                    if take <= 0:
                        if max_points is not None and \
                                m.planned >= max_points:
                            m.stopped = True
                        active[mi] = False
                        continue
                    takes[mi] = take
                    descs[mi] = m.descriptor(produced[mi], take, s_pad, idt)
                    m.planned += take
                    produced[mi] += take
                    if produced[mi] >= m.total:
                        active[mi] = False
                    if max_points is not None and m.planned >= max_points:
                        m.stopped = True
                if not takes.any():
                    break
                if mesh is None:
                    with _metrics.device_dispatch("fleet_bf_chunk",
                                                  bucket=bi):
                        outs = [_bf_chunk_core(static, B, k == 0, A,
                                               t(descs), sigma_d, T_d, cb_d,
                                               t(takes), max_parts)]
                else:
                    with _metrics.device_dispatch("fleet_bf_chunk_shard",
                                                  bucket=bi, devices=D):
                        descs_d, takes_d = t(descs), t(takes)
                        outs = [_bf_chunk_core(
                            static, B, k == 0, A_s, descs_d[lo:hi].to(dev),
                            sig_s, T_s, cb_s, takes_d[lo:hi].to(dev),
                            max_parts)
                            for dev, lo, hi, (A_s, sig_s, T_s, cb_s)
                            in shards]
                pending.append((outs, takes, cb_np))
                if len(pending) > 1:
                    absorb(pending.pop(0))
            for entry in pending:       # drain at the cut-set boundary
                absorb(entry)
        bucket_sp.__exit__(None, None, None)
        elapsed = bucket_sp.elapsed_s()
        for m in members:
            results[m.index] = m.result(elapsed)
    return results


# ----------------------------------------------------------------------
# simulated annealing
# ----------------------------------------------------------------------

def _bucket_tables(members: Sequence):
    """Shared bucket stacking prep for the SA and rule-based fleets:
    common pad sizes plus each member's move tables, built once with the
    clamp value axis extended to the bucket's largest platform fold value
    (``pad_val = lut_pad - 2``, exact — see ``build_sa_tables``) and the
    menu axis padded to the bucket radix with fold 1 (padded entries are
    never drawn/probed: ``menu_sizes`` is unchanged and the rule-based
    in-menu test excludes them). Returns
    ``(n_pad, pairs_pad, vals_pad, lut_pad, tabs)``."""
    n_pad = max(len(p.graph.nodes) for p in members)
    pairs_pad = max(
        (len(p.batched().scan_pairs) for p in members),
        default=0) or 1
    vals_pad, lut_pad = _platform_pads(members)
    tabs = [build_sa_tables(p, pad_nodes=n_pad, pad_val=lut_pad - 2)
            for p in members]
    mm_pad = max(t[0].shape[-1] for t in tabs)
    tabs = [(np.pad(t[0], ((0, 0), (0, 0),
                          (0, mm_pad - t[0].shape[-1])),
                    constant_values=1),) + t[1:] for t in tabs]
    return n_pad, pairs_pad, vals_pad, lut_pad, tabs


def _stack_lanes(tensors) -> torch.Tensor:
    return torch.stack(list(tensors))


def _cloned(gen: torch.Generator, device=None) -> torch.Generator:
    """A new generator on ``device`` (default: ``gen``'s) in ``gen``'s
    state: it draws what ``gen`` would draw next, without advancing it."""
    g = torch.Generator(device=gen.device if device is None else device)
    g.set_state(gen.get_state())
    return g


def _gen_on(gen: torch.Generator, device) -> torch.Generator:
    """``gen`` itself where it lives on ``device``; else its clone there
    (a CUDA generator's state is a seed and an offset, which every card
    continues alike)."""
    return gen if gen.device == torch.device(device) else \
        _cloned(gen, device)


def _rb_stack(rbs, mesh=None):
    """The lane-stacked device tables of rule-based lanes built at shared
    pads: ``(A, menus, menu_sizes, clamp, amort)``, each with a leading
    lane axis. With a ``mesh`` (``_fleet_mesh``), the lanes padded with
    copies of lane 0's up to a multiple of the shard count, split into
    the shards' ``(device, lo, hi, tables)`` (``_shards``)."""
    if mesh is not None:
        pad = _pad_lanes(len(rbs), len(mesh)) - len(rbs)
        return _shards(mesh, len(rbs) + pad,
                       *_rb_stack(rbs + [rbs[0]] * pad))
    return (stack_tensors([r.A for r in rbs]),
            _stack_lanes(r.menus for r in rbs),
            _stack_lanes(r.menu_sizes for r in rbs),
            _stack_lanes(r.clamp for r in rbs),
            _stack_lanes(r.amort for r in rbs))


def _rb_round(rbs, pending, stacked, *, bucket, rnd: int,
              d2h_span: str, mesh=None) -> list:
    """One lockstep round of rule-based lanes, shared by
    ``fleet_rule_based`` and the service's ``run_rule_based_lockstep``.

    ``pending[i]`` is lane i's descent request ``(v, part)``, or None for
    an inert lane (no request this round, or a generator that has
    returned), which rides as ``cap == 0``. Packs every request, makes ONE
    lane-stacked ``_rb_descend_core`` call over ``stacked`` (``_rb_stack``
    of ``rbs``: one read of the loop condition and two segred launches a
    step, whatever the lane count), reads the lanes back under
    ``d2h_span`` and unpacks them. Returns the responses, None where
    nothing was pending.

    With a ``mesh`` (``stacked`` then ``_rb_stack(rbs, mesh)``) it makes
    one call a shard over the shard's lanes, padding lanes as ``cap == 0``
    lanes, every shard before the readback. Each shard takes the round's
    ``max_parts``, so every row adds as many partition terms as it does
    unsharded."""
    static, gran = rbs[0].static, rbs[0].gran
    t = _to(rbs[0].device)
    P = len(rbs) if mesh is None else _pad_lanes(len(rbs), len(mesh))
    n_pad = static.n_nodes
    E = max(n_pad - 1, 0)
    si = np.ones((P, n_pad), np.int64)
    so = np.ones((P, n_pad), np.int64)
    kk = np.ones((P, n_pad), np.int64)
    cb = np.zeros((P, E), bool)
    pm = np.zeros((P, n_pad), bool)
    pidx = np.zeros(P, np.int64)
    cap = np.zeros(P, np.int64)              # 0 => masked no-op lane
    for li, req in enumerate(pending):
        if req is None:
            continue
        v, part = req
        (si[li], so[li], kk[li], cb[li], pm[li], pidx[li],
         cap[li]) = rbs[li].pack_request(v, part)
    max_parts = 1 + max(len(req[0].cuts) for req in pending
                        if req is not None)
    req = [t(x) for x in (si, so, kk, cb, pm, pidx, cap)]
    call = lambda A_st, menus_st, sizes_st, clamp_st, amort, req: \
        _rb_descend_core(static, gran, A_st, menus_st, sizes_st, clamp_st,
                         *req[:6], amort, req[6], max_parts)
    if mesh is None:
        with _metrics.device_dispatch("fleet_rb_descend", bucket=bucket,
                                      round=rnd):
            outs = [call(*stacked, req)]
    else:
        with _metrics.device_dispatch("fleet_rb_descend_shard",
                                      bucket=bucket, round=rnd,
                                      devices=len(mesh)):
            outs = [call(*tables, [x[lo:hi].to(dev) for x in req])
                    for dev, lo, hi, tables in stacked]
    with _trace.span(d2h_span):
        o_si, o_so, o_kk, pts = _gather_lanes(outs)
    return [None if req is None else
            rbs[li].unpack(req[0], o_si[li], o_so[li], o_kk[li], pts[li])
            for li, req in enumerate(pending)]


@torch.no_grad()
def fleet_annealing(problems: Sequence, seed: int = 0,
                    k_start: float = 1000.0, k_min: float = 1.0,
                    cooling: float = 0.98,
                    max_iters: Optional[int] = None,
                    objective_scale: Optional[float] = None,
                    chains: int = 1,
                    devices: Optional[int] = None,
                    device=None) -> List[OptimResult]:
    """Multi-problem device SA.

    One sweep loop advances every problem's chains in lockstep — proposal,
    on-device repair, evaluation, Metropolis and incumbent tracking stay on
    the card for the whole schedule (no host sync mid-sweep), with one
    readback of the traces at the end. Per-problem trajectories are
    bit-identical to ``simulated_annealing(problem, engine="torch")`` with
    the same seed: the sweep body is shared, and each lane draws from its
    own generator, seeded with ``seed``, exactly what its single-problem
    run draws (its node draw bounded by its own node count). As in
    ``fleet_brute_force``, each result's ``seconds`` is its bucket's wall
    time (members sweep simultaneously). Under ``devices=D`` a ragged
    bucket pads with duplicates of lane 0, each drawing from its own clone
    of lane 0's generator, so that no two lanes share a generator.
    """
    from repro_torch.core.optimizers.annealing import (
        LADDER_SPREAD,
        _scale_for,
    )

    chains = max(chains, 1)
    mesh, D, device = _fleet_mesh(devices, device)
    results: List[Optional[OptimResult]] = [None] * len(problems)
    with _trace.span("fleet.bucketing", problems=len(problems),
                     optimiser="annealing") as bsp:
        buckets = bucket_indices(problems, tiered=False)
        bsp.set(buckets=len(buckets))
    for bi, idxs in enumerate(buckets):
        bucket_sp = _trace.span("fleet.sa.bucket", bucket=bi,
                                members=len(idxs))
        bucket_sp.__enter__()
        members = [problems[i] for i in idxs]
        n_pad, pairs_pad, vals_pad, lut_pad, tabs = _bucket_tables(members)
        sas = [DeviceSA(p, device=device, pad_nodes=n_pad,
                        pad_pairs=pairs_pad, pad_vals=vals_pad,
                        pad_lut=lut_pad, tables=tb)
               for p, tb in zip(members, tabs)]
        _same_program(sas, "fleet_annealing")
        if any(s.has_cut_edges != sas[0].has_cut_edges for s in sas):
            raise RuntimeError("fleet_annealing: bucketed problems must "
                               "agree on having cut edges")
        fdt = sas[0].A.flops.dtype
        dev = sas[0].device

        ev0s, scales, states = [], [], []
        for p, sa in zip(members, sas):
            v0 = repair(p, p.backend.initial(p.graph))
            ev0 = p.evaluate(v0)
            ev0s.append(ev0)
            scales.append(_scale_for(ev0, objective_scale))
            states.append(sa.init_state(v0, ev0, chains, seed))
        # ragged-shard padding: duplicates of lane 0, never read back
        pad = _pad_lanes(len(members), D) - len(members)
        sas_p = sas + [sas[0]] * pad
        states += [dict(states[0], gen=_cloned(states[0]["gen"]))
                   for _ in range(pad)]
        scales += [scales[0]] * pad
        temps = torch.tensor([[k_start * (LADDER_SPREAD ** c)
                               for c in range(chains)]] * len(sas_p),
                             dtype=fdt, device=dev)

        if max_iters is not None:
            total_sweeps = max(1, -(-max_iters // chains))
        else:
            total_sweeps = max(1, math.ceil(math.log(k_min / k_start)
                                            / math.log(cooling)))

        keys = [k for k in states[0] if k != "gen"]
        stacks = (stack_tensors([s.A for s in sas_p]),
                  _stack_lanes(s.menus for s in sas_p),
                  _stack_lanes(s.menu_sizes for s in sas_p),
                  _stack_lanes(s.clamp for s in sas_p),
                  _stack_lanes(s.kv_fix for s in sas_p), temps,
                  *(_stack_lanes(st[k] for st in states) for k in keys))
        n_valid = [s.n_real for s in sas_p]
        gens = [st["gen"] for st in states]
        max_parts = max(s.max_parts for s in sas)

        def sweeps(lo, hi, dev, A, menus, menu_sizes, clamp, kv_fix, tmp,
                   *st):
            state = dict(zip(keys, st))
            state["gen"] = [_gen_on(g, dev) for g in gens[lo:hi]]
            return _sa_sweeps(
                sas[0].static, sas[0].gran, sas[0].has_cut_edges,
                total_sweeps, n_valid[lo:hi], A, menus, menu_sizes, clamp,
                kv_fix, state, tmp, scales[lo:hi], cooling, k_min, None,
                max_parts)

        if mesh is None:
            with _metrics.device_dispatch("fleet_sa_sweeps", bucket=bi,
                                          sweeps=total_sweeps):
                state_st, _, traces = sweeps(0, len(members), dev, *stacks)
        else:
            with _metrics.device_dispatch("fleet_sa_sweeps_shard",
                                          bucket=bi, sweeps=total_sweeps,
                                          devices=D):
                outs = [sweeps(lo, hi, sd, *sl)
                        for sd, lo, hi, sl in _shards(mesh, len(sas_p),
                                                      *stacks)]
            state_st = {k: torch.cat([o[0][k].to(dev) for o in outs])
                        for k in keys}
            traces = tuple(torch.cat([o[2][i].to(dev) for o in outs], dim=1)
                           for i in range(2))
        with _trace.span("fleet.d2h.sa_traces"):
            tr = torch.stack([traces[0].to(torch.float64),
                              traces[1].to(torch.float64)]).cpu().numpy()
            t_obj, t_feas = tr[0], tr[1].astype(bool)   # [sweeps, P, C]
        bucket_sp.__exit__(None, None, None)
        elapsed = bucket_sp.elapsed_s()

        for mi, (p, sa, ev0) in enumerate(zip(members, sas, ev0s)):
            history = [(0, ev0.objective)]
            g_best, g_feas = ev0.objective, ev0.feasible
            for t in range(total_sweeps):
                row_f = t_feas[t, mi]
                if row_f.any():
                    c = int(np.argmin(np.where(row_f, t_obj[t, mi], np.inf)))
                else:
                    c = int(np.argmin(t_obj[t, mi]))
                if incumbent_better(bool(row_f[c]), float(t_obj[t, mi, c]),
                                    g_feas, g_best):
                    g_best = float(t_obj[t, mi, c])
                    g_feas = bool(row_f[c])
                    history.append(((t + 1) * chains, g_best))
            member_state = {k: v[mi] for k, v in state_st.items()
                            if k != "gen"}
            best_v, best_obj, best_feas = None, np.inf, False
            for v, o, f in sa.best_variables(member_state):
                if best_v is None or incumbent_better(f, o, best_feas,
                                                      best_obj):
                    best_v, best_obj, best_feas = v, o, f
            best_eval = p.evaluate(best_v)
            p.note_batch_evals(total_sweeps * chains)
            results[idxs[mi]] = OptimResult(
                best_v, best_eval, total_sweeps * chains, elapsed, history,
                name=f"annealing-torch{chains}")
    return results


# ----------------------------------------------------------------------
# rule based (Algorithm 2)
# ----------------------------------------------------------------------

@torch.no_grad()
def fleet_rule_based(problems: Sequence,
                     time_budget_s: Optional[float] = None,
                     multi_start: bool = True,
                     devices: Optional[int] = None,
                     device=None) -> List[OptimResult]:
    """Multi-problem rule-based optimisation (Algorithm 2).

    Every problem runs the SAME host control flow as the per-problem
    engine — ``rule_based._algorithm2`` is instantiated once per problem
    as a generator — but the greedy descents the generators request are
    answered in lockstep: one lane-stacked ``_rb_descend_core`` call per
    round advances every pending problem's descent to convergence, one
    step of the whole bucket at a time (one read of the loop condition
    and two segred launches a step, whatever the number of lanes). Problems
    with no pending request ride along as ``cap == 0`` lanes and lanes
    that converge early as explicit no-ops; the round loop continues until
    every generator has returned. Per-problem merge sequences, final
    designs, objectives, point counts and histories are identical to
    ``rule_based(problem, engine="torch")`` loops. Each result's
    ``seconds`` comes from its own ``_algorithm2`` clock, which in a fleet
    measures the shared lockstep wall time. A bucket may mix platforms AND
    objectives — both are device data.

    ``time_budget_s`` is a BUCKET-level budget: every member's clock
    measures the shared lockstep wall time, so a budgeted fleet truncates
    each problem's multi-start/merge work differently than its own
    per-problem loop would — per-problem bit-identity holds only for
    ``time_budget_s=None``. ``optimise_portfolio`` therefore routes
    budgeted rule-based portfolios through the per-problem loop.

    ``devices=D`` makes each round one descent call a shard
    (``_rb_round``); ragged lane counts pad with ``cap = 0`` lanes.
    """
    from repro_torch.core.optimizers.rule_based import _algorithm2

    mesh, D, device = _fleet_mesh(devices, device)
    results: List[Optional[OptimResult]] = [None] * len(problems)
    with _trace.span("fleet.bucketing", problems=len(problems),
                     optimiser="rule_based") as bsp:
        buckets = bucket_indices(problems, tiered=False)
        bsp.set(buckets=len(buckets))
    for bi, idxs in enumerate(buckets):
        # attribution only: rule-based ``seconds`` comes from each
        # member's ``_algorithm2`` clock, not from the bucket span
        bucket_sp = _trace.span("fleet.rb.bucket", bucket=bi,
                                members=len(idxs))
        bucket_sp.__enter__()
        members = [problems[i] for i in idxs]
        n_pad, pairs_pad, vals_pad, lut_pad, tabs = _bucket_tables(members)
        rbs = [DeviceRuleBased(p, device=device, pad_nodes=n_pad,
                               pad_pairs=pairs_pad, pad_vals=vals_pad,
                               pad_lut=lut_pad, tables=tb)
               for p, tb in zip(members, tabs)]
        _same_program(rbs, "fleet_rule_based")
        stacked = _rb_stack(rbs, mesh)

        gens = [_algorithm2(p, time_budget_s, multi_start) for p in members]
        pending: List[Optional[tuple]] = []
        for li, g in enumerate(gens):
            try:
                pending.append(next(g))
            except StopIteration as stop:    # pragma: no cover (>= 1 part)
                results[idxs[li]] = stop.value
                pending.append(None)

        rnd = 0
        while any(req is not None for req in pending):
            resps = _rb_round(rbs, pending, stacked, bucket=bi, rnd=rnd,
                              d2h_span="fleet.d2h.rb_descend", mesh=mesh)
            rnd += 1
            for li, resp in enumerate(resps):
                if resp is None:
                    continue
                try:
                    pending[li] = gens[li].send(resp)
                except StopIteration as stop:
                    results[idxs[li]] = stop.value
                    pending[li] = None
        bucket_sp.__exit__(None, None, None)
    return results
