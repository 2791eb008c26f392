"""Objectives (paper §III-D, Eq. 2-4) and the Problem bundle.

``Problem`` ties together graph + platform + backend rules + objective and is
the single evaluation interface all three optimisers use. Evaluation returns
an ``Evaluation`` carrying the objective value O(V) (Eq. 5: lower is better
for both objectives — throughput is negated per Eq. 4), the constraint
report, and diagnostic breakdowns.

``CoMapProblem`` extends the model to the f-CNNx scenario: N networks
sharing ONE platform, with the resource partition between nets part of
the searched candidate. A joint candidate is (split, per-net designs)
where the split assigns each net a disjoint sub-platform
(``platform.split_axis0``) from a deterministic menu — the
resource-partition decision axis — and the composite objective combines
the per-net evaluations (weighted throughput, worst-case latency, or
max-min fairness). This module is the float64 scalar REFERENCE;
``core/batched_eval.CoMapBatchedEvaluator`` and ``core/accel`` mirror it
(docs/comapping.md walks the model end to end).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import constraints as C
from repro_torch.core.hdgraph import HDGraph, Variables, partitions_from_cuts
from repro_torch.core.perfmodel import (
    ModelOptions,
    NodeEval,
    eval_nodes,
    partition_time,
    t_conf,
)
from repro_torch.core.platform import Platform, enumerate_chip_splits, split_axis0


@dataclass(frozen=True)
class Evaluation:
    objective: float                      # O(V), lower is better (Eq. 5)
    feasible: bool
    violations: Tuple[str, ...]
    partition_times: Tuple[float, ...]    # T(P_i), Eq. 2
    reconf_time: float                    # |C| * t_conf
    latency: float                        # Eq. 3
    throughput: float                     # positive items/s (Eq. 4 un-negated)
    node_evals: Tuple[NodeEval, ...] = ()

    @property
    def total_chips(self) -> int:
        return sum(e.chips for e in self.node_evals)


@dataclass
class Problem:
    """One optimisation instance (paper Eq. 5)."""

    graph: HDGraph
    platform: Platform
    backend: "Backend"                    # forward ref (core/backends.py)
    objective: str = "throughput"         # latency | throughput
    exec_model: str = "streaming"         # streaming | spmd
    batch_amortisation: int = 256         # B in Eq. 4 (batches per config sweep)
    opts: ModelOptions = field(default_factory=ModelOptions)

    _eval_count: int = 0                  # points/s accounting (Table IV)
    _cache: dict = field(default_factory=dict, repr=False)
    _cache_cap: int = 200_000

    # ------------------------------------------------------------------
    def check(self, v: Variables) -> C.ConstraintReport:
        cached = self._cache.get(("check", v))
        if cached is not None:
            return cached
        rep = C.check_all(self.graph, v, self.platform, self._eval_nodes(v),
                          self.exec_model, self.backend, C.ConstraintReport())
        if len(self._cache) < self._cache_cap:
            self._cache[("check", v)] = rep
        return rep

    def _eval_nodes(self, v: Variables):
        """eval_nodes with per-(node, fold-triple) memoisation — probes
        change one scope at a time, so most triples repeat."""
        memo = self._cache.setdefault("node_memo", {})
        out = []
        for i, n in enumerate(self.graph.nodes):
            key = (i, v.s_in[i], v.s_out[i], v.kern[i])
            e = memo.get(key)
            if e is None:
                from repro_torch.core.perfmodel import node_eval
                e = node_eval(n, key[1], key[2], key[3], self.platform,
                              self.graph.mode, self.opts)
                memo[key] = e
            out.append(e)
        return out

    def evaluate(self, v: Variables, with_nodes: bool = False) -> Evaluation:
        cached = self._cache.get(v)
        if cached is not None:
            return cached
        self._eval_count += 1
        evals = self._eval_nodes(v)
        rep = C.check_all(self.graph, v, self.platform, evals,
                          self.exec_model, self.backend, C.ConstraintReport())

        parts = partitions_from_cuts(self.graph, v.cuts)
        p_times = []
        for part in parts:
            t = partition_time(self.graph, part, evals, self.exec_model)
            # backends without inter-matching pay resharding collectives at
            # layout changes inside the partition (spmd backend, Table II).
            if not self.backend.inter_matching:
                t += self._resharding_time(v, part, evals)
            p_times.append(t)
        reconf = sum(
            t_conf(self.graph, part, v, self.platform) for part in parts[1:]
        )  # |C| swaps: first configuration is pre-loaded (paper Eq. 3)

        latency = sum(p_times) + reconf                        # Eq. 3
        Bam = self.batch_amortisation
        thr_time = Bam * sum(p_times) + reconf                 # Eq. 4 denominator
        throughput = Bam / thr_time if thr_time > 0 else 0.0

        obj = latency if self.objective == "latency" else -throughput
        result = Evaluation(
            objective=obj,
            feasible=rep.ok,
            violations=tuple(rep.violations),
            partition_times=tuple(p_times),
            reconf_time=reconf,
            latency=latency,
            throughput=throughput,
            node_evals=tuple(evals),
        )
        if len(self._cache) < self._cache_cap:
            self._cache[v] = result
        return result

    def _resharding_time(self, v: Variables, part, evals) -> float:
        """Cost of an activation-layout change between adjacent nodes inside
        one compiled partition (spmd backend: inter matching not enforced).

        Priced at GSPMD's observed fallback for arbitrary sharding
        transitions — "involuntary full rematerialization": the tensor is
        replicated (all-gather of the full featuremap) and re-partitioned.
        Per-chip traffic = the FULL boundary featuremap. This is deliberately
        punitive: it matches what XLA actually emits, and it drives the
        optimiser towards layout-uniform partitions (DESIGN.md §2)."""
        t = 0.0

        def b_in(i: int) -> int:
            return 1 if self.graph.nodes[i].internal_rows else v.s_in[i]

        for a, b in zip(part[:-1], part[1:]):
            if b_in(a) != b_in(b) or v.kern[a] != v.kern[b]:
                na = self.graph.nodes[a]
                rows = na.rows if self.graph.mode != "decode" else 1
                if na.internal_rows:
                    rows = 1
                full = na.batch * rows * na.fm_width * 2.0
                t += full / self.platform.ici_bw
        return t

    # ------------------------------------------------------------------
    # batched evaluation (core/batched_eval.py)
    # ------------------------------------------------------------------
    def batched(self):
        """The cached vectorised evaluator for this problem instance.

        Lowers the graph/platform into flat arrays on first use; subsequent
        calls reuse the lowering. Returns a
        ``repro.core.batched_eval.BatchedEvaluator``.
        """
        be = self._cache.get("__batched__")
        if be is None:
            from repro_torch.core.batched_eval import BatchedEvaluator
            be = BatchedEvaluator.from_problem(self)
            self._cache["__batched__"] = be
        return be

    def evaluate_many(self, designs) -> "BatchResult":
        """Batched evaluate of a sequence of ``Variables`` (one array
        program; counts towards the Table-IV points/s accounting)."""
        be = self.batched()
        res = be.evaluate_batch(*be.pack(list(designs)))
        self.note_batch_evals(len(res))
        return res

    def note_batch_evals(self, n: int) -> None:
        """Account ``n`` batched design-point evaluations (Table IV)."""
        self._eval_count += n

    @property
    def evals_done(self) -> int:
        return self._eval_count


# ----------------------------------------------------------------------
# Multi-network co-mapping (f-CNNx scenario; docs/comapping.md)
# ----------------------------------------------------------------------

#: composite objectives a CoMapProblem accepts (all lower-is-better):
#:   weighted_throughput  -sum_i w_i * thr_i
#:   worst_latency         max_i lat_i
#:   maxmin_throughput    -min_i w_i * thr_i   (max-min fairness)
COMAP_OBJECTIVES = ("weighted_throughput", "worst_latency",
                    "maxmin_throughput")


def combine_composite(objective: str, weights: Sequence[float],
                      per_net: Sequence[Evaluation]) -> float:
    """Fold N per-net evaluations into one composite objective value.

    Pure float64 host arithmetic shared by every engine rung: given
    identical per-net evaluations, the composite is bit-identical
    regardless of which engine produced the designs. All three
    composites are monotone in each net's own objective, which is what
    makes the per-(split, net) decomposition of the joint search exact
    (docs/comapping.md, "why the decomposition is exact")."""
    if objective == "worst_latency":
        return max(e.latency for e in per_net)
    thr = [w * e.throughput for w, e in zip(weights, per_net)]
    if objective == "maxmin_throughput":
        return -min(thr)
    if objective == "weighted_throughput":
        return -sum(thr)
    raise ValueError(f"unknown composite objective {objective!r}; "
                     f"choose from {COMAP_OBJECTIVES}")


@dataclass(frozen=True)
class CoMapEvaluation:
    """Joint-candidate analogue of ``Evaluation``."""

    objective: float                    # composite, lower is better
    feasible: bool                      # budget ok AND every net feasible
    violations: Tuple[str, ...]         # shared-budget + per-net, prefixed
    split_index: int                    # -1: no split (empty menu)
    split: Tuple[int, ...]              # axis-0 chunk per net (() if none)
    split_chips: Tuple[int, ...]        # chips per net under the split
    per_net: Tuple[Evaluation, ...]     # scalar-reference evaluations


@dataclass
class CoMapProblem:
    """N networks co-mapped onto one shared platform (paper Eq. 5 per
    net + an f-CNNx resource coupling across nets).

    ``splits`` is the resource-partition decision axis: a tuple of
    axis-0 chunk compositions, each assigning every net a disjoint
    sub-platform (``split_axis0``). ``None`` resolves to the full
    deterministic menu (``enumerate_chip_splits`` — every ordered
    composition of mesh axis 0 into N positive chunks; empty when the
    axis has fewer slices than nets, making the co-mapping infeasible).
    ``weights`` (default all 1.0) enter the throughput composites.
    """

    graphs: List[HDGraph]
    platform: Platform
    backend: "Backend"                    # forward ref (core/backends.py)
    objective: str = "weighted_throughput"
    weights: Optional[Tuple[float, ...]] = None
    exec_model: str = "streaming"         # streaming | spmd
    batch_amortisation: int = 256
    opts: ModelOptions = field(default_factory=ModelOptions)
    splits: Optional[Tuple[Tuple[int, ...], ...]] = None

    _cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.graphs:
            raise ValueError("CoMapProblem needs at least one graph")
        if self.objective not in COMAP_OBJECTIVES:
            raise ValueError(
                f"unknown composite objective {self.objective!r}; "
                f"choose from {COMAP_OBJECTIVES}")
        if self.weights is not None:
            if len(self.weights) != len(self.graphs):
                raise ValueError(
                    f"got {len(self.graphs)} graphs but "
                    f"{len(self.weights)} weights")
            if any(w <= 0 for w in self.weights):
                raise ValueError(f"weights must be positive, got "
                                 f"{self.weights}")

    # ------------------------------------------------------------------
    @property
    def n_nets(self) -> int:
        return len(self.graphs)

    @property
    def net_weights(self) -> Tuple[float, ...]:
        return (tuple(float(w) for w in self.weights)
                if self.weights is not None
                else (1.0,) * self.n_nets)

    @property
    def per_net_objective(self) -> str:
        """The Eq. 5 objective each sub-problem optimises: monotone
        alignment with the composite (latency composites minimise each
        net's latency, throughput composites maximise each net's
        throughput)."""
        return ("latency" if self.objective == "worst_latency"
                else "throughput")

    def resolved_splits(self) -> Tuple[Tuple[int, ...], ...]:
        """The decision-axis menu (memoised; deterministic order)."""
        menu = self._cache.get("splits")
        if menu is None:
            menu = (tuple(tuple(int(p) for p in s) for s in self.splits)
                    if self.splits is not None
                    else enumerate_chip_splits(self.platform, self.n_nets))
            self._cache["splits"] = menu
        return menu

    def split_platforms(self, split_index: int) -> Tuple[Platform, ...]:
        """The disjoint per-net sub-platforms of one split (memoised)."""
        key = ("plats", split_index)
        plats = self._cache.get(key)
        if plats is None:
            plats = split_axis0(self.platform,
                                self.resolved_splits()[split_index],
                                check_budget=False)
            self._cache[key] = plats
        return plats

    def budget_violations(self, split_index: int) -> List[str]:
        """The coupled shared-budget constraint, evaluated INSIDE the
        candidate: the per-net chip allocations must fit the platform.
        The generated menu satisfies this by construction; user-supplied
        split menus are where it bites."""
        plats = self.split_platforms(split_index)
        total = sum(p.chips for p in plats)
        if total > self.platform.chips:
            return [f"split {split_index}: allocated chips {total} > "
                    f"shared budget {self.platform.chips}"]
        return []

    def subproblem(self, split_index: int, net: int) -> Problem:
        """Net ``net``'s per-net ``Problem`` under one split (memoised —
        sub-problem caches persist across candidate evaluations)."""
        key = ("sub", split_index, net)
        sub = self._cache.get(key)
        if sub is None:
            sub = Problem(
                graph=self.graphs[net],
                platform=self.split_platforms(split_index)[net],
                backend=self.backend,
                objective=self.per_net_objective,
                exec_model=self.exec_model,
                batch_amortisation=self.batch_amortisation,
                opts=self.opts,
            )
            self._cache[key] = sub
        return sub

    def subproblems(self, split_index: int) -> List[Problem]:
        return [self.subproblem(split_index, i)
                for i in range(self.n_nets)]

    # ------------------------------------------------------------------
    def evaluate(self, split_index: int,
                 designs: Sequence[Variables]) -> CoMapEvaluation:
        """Float64 scalar reference for one joint candidate."""
        menu = self.resolved_splits()
        if not (0 <= split_index < len(menu)):
            raise ValueError(f"split_index {split_index} out of range "
                             f"for a {len(menu)}-split menu")
        if len(designs) != self.n_nets:
            raise ValueError(f"got {len(designs)} designs for "
                             f"{self.n_nets} nets")
        viols = list(self.budget_violations(split_index))
        per = tuple(self.subproblem(split_index, i).evaluate(v)
                    for i, v in enumerate(designs))
        for i, e in enumerate(per):
            viols.extend(f"net {i}: {m}" for m in e.violations)
        return CoMapEvaluation(
            objective=combine_composite(self.objective, self.net_weights,
                                        per),
            feasible=not viols,
            violations=tuple(viols),
            split_index=split_index,
            split=menu[split_index],
            split_chips=tuple(p.chips
                              for p in self.split_platforms(split_index)),
            per_net=per,
        )

    def infeasible_evaluation(self, reason: str) -> CoMapEvaluation:
        """The canonical no-feasible-candidate result (empty split menu,
        or every split infeasible)."""
        return CoMapEvaluation(objective=math.inf, feasible=False,
                               violations=(reason,), split_index=-1,
                               split=(), split_chips=(), per_net=())

    def batched(self):
        """The cached vectorised co-map evaluator
        (``repro.core.batched_eval.CoMapBatchedEvaluator``)."""
        be = self._cache.get("__batched__")
        if be is None:
            from repro_torch.core.batched_eval import CoMapBatchedEvaluator
            be = CoMapBatchedEvaluator(self)
            self._cache["__batched__"] = be
        return be
