"""Admission queue and dynamic-membership lockstep rounds of the mapping
service (the port of ``repro.service.queue``).

Two halves:

``AdmissionQueue``
    A thread-safe, bounded FIFO of pending requests. ``submit()`` pushes
    (raising :class:`ServiceOverloaded` at capacity — bounded
    backpressure, never unbounded memory), the dispatcher drains either
    everything (``drain``) or only the requests matching a predicate
    (``drain_matching`` — the late-joiner poll of an in-flight lockstep
    round). Queue depth is exported as the ``service.queue.depth`` gauge.

``run_rule_based_lockstep``
    The streaming twin of ``fleet.fleet_rule_based``: every job's
    ``rule_based._algorithm2`` generator is advanced by one lane-stacked
    ``search_loops._rb_descend_core`` call per round, exactly like the
    fleet — but membership is DYNAMIC. A ``poll`` callback runs at every
    round boundary and may hand over newly arrived jobs from the queue:
    they join the next round as fresh lanes (late joiners). Jobs whose
    generator returns keep their lane as a ``cap == 0`` no-op until the
    next membership change compacts the stack (early leavers) — the same
    inert-lane contract the fleet uses for members with no pending
    request. Because the descent body, the pack/unpack lowering and the
    host merge loop are the fleet's own code, the evaluator's float sums
    are order-fixed and padding is bit-neutral, every job's final design,
    objective, point count and history are bitwise those of a direct
    ``rule_based(problem, engine="torch")`` call on the same device —
    tests/test_torch_service.py asserts it.

Every statement but this docstring and ``run_rule_based_lockstep`` is the
JAX package's. torch comes in only with the fleet module, which
``run_rule_based_lockstep`` imports when it runs.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["ServiceError", "ServiceOverloaded", "ServiceClosed",
           "DeadlineExceeded", "AdmissionQueue", "LockstepJob",
           "run_rule_based_lockstep"]


class ServiceError(RuntimeError):
    """Base class for mapping-service failures."""


class ServiceOverloaded(ServiceError):
    """The pending queue is full — resubmit later (bounded backpressure)."""


class ServiceClosed(ServiceError):
    """The server is shutting down (or closed) and accepts no new work."""


class DeadlineExceeded(ServiceError):
    """The request's deadline passed before its design was delivered."""


class AdmissionQueue:
    """Bounded thread-safe FIFO with predicate draining (see module doc)."""

    def __init__(self, maxsize: int = 256) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._items: deque = deque()

    def _gauge(self) -> None:
        _metrics.gauge("service.queue.depth").set(len(self._items))

    def push(self, item) -> None:
        with self._nonempty:
            if len(self._items) >= self.maxsize:
                _metrics.counter("service.requests.rejected").inc()
                raise ServiceOverloaded(
                    f"pending queue is full ({self.maxsize} requests); "
                    f"retry later or raise max_pending")
            self._items.append(item)
            self._gauge()
            self._nonempty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is non-empty (or timeout); True if so."""
        with self._nonempty:
            if not self._items:
                self._nonempty.wait(timeout)
            return bool(self._items)

    def drain(self) -> List:
        with self._lock:
            out = list(self._items)
            self._items.clear()
            self._gauge()
        return out

    def drain_matching(self, pred: Callable) -> List:
        """Remove and return the pending items with ``pred(item)`` true,
        preserving FIFO order of the rest — the in-flight round's
        late-joiner poll."""
        with self._lock:
            out = [i for i in self._items if pred(i)]
            if out:
                self._items = deque(i for i in self._items
                                    if not pred(i))
                self._gauge()
        return out


# ----------------------------------------------------------------------
# dynamic-membership lockstep rounds (rule_based, torch engine)
# ----------------------------------------------------------------------

class LockstepJob:
    """One rule-based mapping job for the lockstep engine. ``tag`` is an
    opaque caller handle (the server keeps its request group there)."""

    __slots__ = ("problem", "multi_start", "tag")

    def __init__(self, problem, multi_start: bool = True, tag=None):
        self.problem = problem
        self.multi_start = multi_start
        self.tag = tag


class _Lane:
    __slots__ = ("job", "gen", "pending", "rb")

    def __init__(self, job, gen):
        self.job = job
        self.gen = gen
        self.pending = None          # (v, part) request or None when done
        self.rb = None               # DeviceRuleBased at the shared pads


def run_rule_based_lockstep(jobs: Sequence[LockstepJob],
                            poll: Optional[Callable[[], List[LockstepJob]]]
                            = None,
                            on_done: Optional[Callable] = None,
                            device=None) -> List:
    """Advance many rule-based jobs in dynamic-membership lockstep rounds.

    All jobs (initial and polled) must share one program-shape bucket
    (``fleet.bucket_key(problem)`` — the caller groups by it) and run on
    one ``device`` (default: the card; ``"cpu"`` runs segred's plain
    version; with no card and no ``device`` it raises
    ``EngineUnavailable``). ``poll`` is invoked at every round boundary and
    returns newly admitted jobs (or ``[]``); ``on_done(job, result)`` fires
    the moment a job's generator returns, so early leavers resolve without
    waiting for the round loop to drain. Returns ``[(job, OptimResult),
    ...]`` in completion order.

    A round is the fleet's own round (``fleet._rb_round``): ONE
    ``_rb_descend_core`` call over the stacked lanes, one read of the loop
    condition and two segred launches a step, whatever the lane count.
    Padding of the node, scan-pair, fold-value and menu axes grows
    monotonically (tiered to ``fleet.NODE_TIER`` multiples), so late
    joiners usually fit the stack's pads; a joiner that needs bigger ones
    rebuilds every pending lane at the new pads (counted in
    ``service.rounds.restacks``). Each lane's move tables are built once
    and rebuilt only when the node or fold-value pad grew; a grown menu
    pad only re-pads them. Results are unaffected either way: padding is
    bit-neutral. The JAX package also pads the lane count to a power of
    two, so that its jitted executable is not retraced for every lane
    count; eager PyTorch has no trace to keep, so the stack holds exactly
    the admitted lanes. The only inert lanes are early leavers, whose
    ``cap == 0`` keeps them out of every step's loop condition and whose
    folds and points each step carries through unchanged.
    """
    from repro_torch.core.accel.fleet import (
        _node_tier,
        _platform_pads,
        _rb_round,
        _rb_stack,
        _same_program,
        bucket_key,
    )
    from repro_torch.core.accel.search_loops import (
        DeviceRuleBased,
        build_sa_tables,
    )
    from repro_torch.core.optimizers.rule_based import _algorithm2
    from repro_torch.runtime import resolve_device

    dev = resolve_device(device)
    pads = {"n": 0, "pairs": 0, "vals": 0, "lut": 0, "mm": 0}
    lanes: List[_Lane] = []
    tabs = {}                        # lane -> ((n, lut) pads, tables)
    done: List = []
    sig = [None]

    def finish(job, result) -> None:
        done.append((job, result))
        if on_done is not None:
            on_done(job, result)

    def tables(lane: _Lane):
        """The lane's move tables at the stack's node and fold-value
        pads, built again only when one of those pads grew."""
        at = (pads["n"], pads["lut"])
        if lane not in tabs or tabs[lane][0] != at:
            tabs[lane] = (at, build_sa_tables(
                lane.job.problem, pad_nodes=pads["n"],
                pad_val=pads["lut"] - 2))
        return tabs[lane][1]

    def build_rb(lane: _Lane) -> DeviceRuleBased:
        tb = tables(lane)
        menus = np.pad(tb[0], ((0, 0), (0, 0),
                               (0, pads["mm"] - tb[0].shape[-1])),
                       constant_values=1)
        return DeviceRuleBased(lane.job.problem, device=dev,
                               pad_nodes=pads["n"], pad_pairs=pads["pairs"],
                               pad_vals=pads["vals"], pad_lut=pads["lut"],
                               tables=(menus,) + tb[1:])

    def admit(new_jobs: Sequence[LockstepJob]) -> bool:
        """Returns True when the lane stack must be rebuilt."""
        fresh: List[_Lane] = []
        for job in new_jobs:
            k = bucket_key(job.problem)
            if sig[0] is None:
                sig[0] = k
            elif k != sig[0]:
                raise ValueError(
                    "lockstep jobs must share one program-shape bucket "
                    "(fleet.bucket_key); the caller groups requests "
                    "before admission")
            gen = _algorithm2(job.problem, None, job.multi_start)
            lane = _Lane(job, gen)
            try:
                lane.pending = next(gen)
            except StopIteration as stop:   # pragma: no cover (>= 1 part)
                finish(job, stop.value)
                continue
            fresh.append(lane)
        if not fresh:
            return False
        grew = False
        for lane in fresh:
            p = lane.job.problem
            va, lu = _platform_pads([p])
            wanted = (("n", _node_tier(len(p.graph.nodes))),
                      ("pairs", max(1, _node_tier(
                          len(p.batched().scan_pairs)))),
                      ("vals", _node_tier(va)),
                      ("lut", _node_tier(lu)))
            for key, v in wanted:
                if v > pads[key]:
                    pads[key] = v
                    grew = True
        # the menu radix only falls out of building the tables
        for lane in fresh:
            mm = _node_tier(tables(lane)[0].shape[-1])
            if mm > pads["mm"]:
                pads["mm"] = mm
                grew = True
        if grew and any(ln.pending is not None for ln in lanes):
            _metrics.counter("service.rounds.restacks").inc()
        # compact early leavers out of the stack while we rebuild anyway
        for lane in lanes:
            if lane.pending is None:
                tabs.pop(lane, None)
        lanes[:] = [ln for ln in lanes if ln.pending is not None]
        for lane in (lanes + fresh) if grew else fresh:
            lane.rb = build_rb(lane)
        lanes.extend(fresh)
        _metrics.counter("service.admissions").inc(len(fresh))
        return True

    stacked = None
    admit(list(jobs))
    rnd = 0
    while True:
        if poll is not None and admit(poll() or []):
            stacked = None
        if not any(ln.pending is not None for ln in lanes):
            break
        rbs = [ln.rb for ln in lanes]
        if stacked is None:
            _same_program(rbs, "run_rule_based_lockstep")
            stacked = _rb_stack(rbs)
        pending = [ln.pending for ln in lanes]
        active = sum(req is not None for req in pending)
        _metrics.gauge("service.lanes").set(active)
        with _trace.span("service.round", round=rnd, lanes=active,
                         lanes_stacked=len(lanes)):
            resps = _rb_round(rbs, pending, stacked, bucket="service",
                              rnd=rnd, d2h_span="service.d2h.round")
        _metrics.counter("service.rounds").inc()
        rnd += 1
        for lane, resp in zip(lanes, resps):
            if resp is None:
                continue
            try:
                lane.pending = lane.gen.send(resp)
            except StopIteration as stop:
                lane.pending = None
                finish(lane.job, stop.value)
    return done
