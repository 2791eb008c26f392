"""Nested span tracer: monotonic, thread-safe, near-free when disabled.

A *span* is one timed region of the optimiser stack — a lowering, a jit
dispatch, a fleet bucket, a whole ``optimise_mapping`` call. Spans nest
(per thread) and carry a small attribute dict, so a recorded run can be
read back as a tree: which bucket, which chunk, how long, how deep.

Design constraints, in order:

  1. **Disabled cost ~ two perf_counter calls.** Instrumentation sits
     inside per-chunk device-call loops; when tracing is off a span
     must not take locks, touch thread-locals or allocate attribute
     dicts. It still *times* itself — callers like ``fleet.py`` use
     ``span.elapsed_s()`` as their wall clock for ``OptimResult.seconds``
     whether or not telemetry is on, which is what keeps results
     bit-identical between telemetry-on and telemetry-off runs.
  2. **Monotonic clocks.** All timestamps are ``time.perf_counter()``
     relative to the tracer epoch (set at ``enable``/``reset``); wall
     time belongs to the run record, not to spans.
  3. **Thread-safe.** The span stack is per-thread; the finished-span
     buffer is lock-guarded and capped (``max_spans``, drops counted)
     so a runaway loop degrades telemetry instead of memory.
  4. **Zero dependencies.** stdlib only; this module is part of the
     ``REPRO_NO_JAX`` import matrix.

Usage::

    from repro_torch.obs import trace

    trace.enable()
    with trace.span("accel.bf.chunk", bucket="b0", chunk=3) as sp:
        ...work...
    sp.elapsed_s()          # always real, enabled or not

    @trace.traced("pipeline.optimise_mapping")
    def optimise_mapping(...): ...

    spans = trace.snapshot()   # list of dicts, see SPAN_FIELDS
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: keys of every dict returned by :func:`snapshot` (the on-disk schema).
SPAN_FIELDS: Tuple[str, ...] = (
    "name", "start_s", "dur_s", "depth", "id", "parent", "thread", "attrs",
)

#: finished-span buffer cap; beyond it spans are dropped (and counted).
DEFAULT_MAX_SPANS = 50_000


class Span:
    """One timed region. Context manager; reusable as a plain stopwatch.

    ``t0``/``t1`` are raw ``perf_counter`` readings taken on enter/exit
    regardless of whether tracing is enabled — only the bookkeeping
    (stack push/pop, attrs, buffer append) is gated on the recording
    flag captured at construction time.
    """

    __slots__ = ("name", "attrs", "t0", "t1", "_rec", "_tr", "id", "parent",
                 "depth")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]],
                 tracer: Optional["Tracer"]) -> None:
        self.name = name
        self.attrs = attrs
        self._rec = tracer is not None
        self._tr = tracer
        self.t0 = 0.0
        self.t1 = -1.0
        self.id = -1
        self.parent = -1
        self.depth = 0

    def __enter__(self) -> "Span":
        if self._rec:
            self._tr._push(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter()
        if self._rec:
            self._tr._pop(self, failed=exc_type is not None)
        return False

    def elapsed_s(self) -> float:
        """Seconds since enter; live while the span is open."""
        end = self.t1 if self.t1 >= 0.0 else time.perf_counter()
        return end - self.t0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (no-op unless this span is being recorded)."""
        if self._rec:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)
        return self


class Tracer:
    """Process-wide span collector. One module-level instance suffices;
    the class exists so tests can build isolated tracers."""

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS) -> None:
        self.max_spans = max_spans
        self._enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._spans: List[Dict[str, Any]] = []
        self._dropped = 0
        self._epoch = time.perf_counter()

    # -- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        """Drop collected spans and restart the epoch clock."""
        with self._lock:
            self._spans = []
            self._dropped = 0
            self._ids = itertools.count()
            self._epoch = time.perf_counter()

    # -- span construction --------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        rec = self._enabled
        return Span(name, attrs if (rec and attrs) else None,
                    self if rec else None)

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator form: the whole call body becomes one span."""
        def deco(fn: Callable) -> Callable:
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(span_name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    # -- internals (called from Span) ----------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span) -> None:
        st = self._stack()
        sp.id = next(self._ids)
        sp.parent = st[-1].id if st else -1
        sp.depth = len(st)
        st.append(sp)

    def _pop(self, sp: Span, failed: bool = False) -> None:
        st = self._stack()
        # tolerate interleaved/foreign exits rather than corrupt the stack
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)
        if failed:
            sp.set(failed=True)
        rec = {
            "name": sp.name,
            "start_s": sp.t0 - self._epoch,
            "dur_s": sp.t1 - sp.t0,
            "depth": sp.depth,
            "id": sp.id,
            "parent": sp.parent,
            "thread": threading.get_ident(),
            "attrs": dict(sp.attrs) if sp.attrs else {},
        }
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1

    # -- output --------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """Finished spans, in completion order (sort by ``start_s`` for
        a chronological view). Returns copies; safe to mutate."""
        with self._lock:
            return [dict(s) for s in self._spans]

    def dropped(self) -> int:
        with self._lock:
            return self._dropped


#: the process-wide tracer every instrumentation point talks to.
_TRACER = Tracer()

# module-level convenience API (bound, not re-looked-up, for call cost)
enable = _TRACER.enable
disable = _TRACER.disable
enabled = _TRACER.enabled
reset = _TRACER.reset
span = _TRACER.span
traced = _TRACER.traced
snapshot = _TRACER.snapshot
dropped = _TRACER.dropped

__all__ = [
    "SPAN_FIELDS", "DEFAULT_MAX_SPANS", "Span", "Tracer",
    "enable", "disable", "enabled", "reset", "span", "traced",
    "snapshot", "dropped",
]
