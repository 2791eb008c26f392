"""Typed metrics registry: counters, gauges, histograms, series.

Always on. A counter increment is a dict lookup plus an integer add —
the same cost class as the bare ``TRACE_COUNTS`` dict this module
absorbs — so instrumentation points don't need an enabled-check. The
exceptions are *derived* observations (feasible fractions, per-chunk
histograms) whose computation costs something; call sites gate those on
``trace.enabled()``.

Instrument types
----------------
  Counter    monotone int; ``inc(n)``. Evaluation counts, dispatches,
             executable-cache hits.
  Gauge      last-written float; ``set(v)``. points/s of the latest run.
  Histogram  count/sum/min/max summary; ``observe(v)``. Chunk sizes,
             feasible fractions.
  Series     bounded list of (x, y) float pairs; ``append(x, y)``.
             Incumbent-objective-vs-points convergence curves.

``TRACE_COUNTS`` back-compat
----------------------------
The jitted engine bodies tick ``TRACE_COUNTS[key] += 1`` as a
host-side side effect that runs once per XLA *trace* (not per call) —
the repo's executable-cache observability primitive since PR 3. That
dict is now a :class:`MutableMapping` view over registry counters
(``accel.traces.<key>``), re-exported unchanged through
``core.accel.eval_jax`` / ``search_loops`` / ``fleet`` so
``assert_max_traces`` and every existing test keep working verbatim.

stdlib-only and jax-free (``REPRO_NO_JAX`` import matrix).
"""
from __future__ import annotations

import sys
import threading
from collections.abc import MutableMapping
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Tuple

from repro_torch.obs import trace

#: cap on points kept per Series (drops are counted in the snapshot).
SERIES_CAP = 4096


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return {"count": self.count, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.total / self.count}


class Series:
    """Bounded (x, y) sample list — convergence curves, mostly."""

    __slots__ = ("points", "dropped")

    def __init__(self) -> None:
        self.points: List[Tuple[float, float]] = []
        self.dropped = 0

    def append(self, x: float, y: float) -> None:
        if len(self.points) < SERIES_CAP:
            self.points.append((float(x), float(y)))
        else:
            self.dropped += 1

    def extend(self, pairs) -> None:
        for x, y in pairs:
            self.append(x, y)


class Registry:
    """Get-or-create instrument store. One module-level instance; the
    class exists so tests can build isolated registries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._series: Dict[str, Series] = {}

    def _get(self, store: Dict[str, Any], name: str, cls: type) -> Any:
        inst = store.get(name)
        if inst is None:
            with self._lock:
                inst = store.get(name)
                if inst is None:
                    inst = store[name] = cls()
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def series(self, name: str) -> Series:
        return self._get(self._series, name, Series)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serialisable view of every instrument."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(self._histograms.items())},
                "series": {k: {"points": [list(p) for p in s.points],
                               "dropped": s.dropped}
                           for k, s in sorted(self._series.items())},
            }

    def reset(self) -> None:
        """Drop every instrument. ``TRACE_COUNTS`` keys re-materialise at
        zero on next access (the view is get-or-create), so delta-based
        consumers like ``assert_max_traces`` are unaffected."""
        with self._lock:
            self._counters = {}
            self._gauges = {}
            self._histograms = {}
            self._series = {}


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
series = REGISTRY.series
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset


# ----------------------------------------------------------------------
# TRACE_COUNTS: the executable-cache trace ledger, as a registry view
# ----------------------------------------------------------------------

#: the jitted engine entry points, one key each (see eval_jax /
#: search_loops / fleet — the ``TRACE_COUNTS[k] += 1`` lines sit first
#: in each jitted body and execute once per XLA trace).
TRACE_KEYS: Tuple[str, ...] = (
    "eval_batch", "sa_sweeps", "bf_chunk", "rb_descend",
    "fleet_sa_sweeps", "fleet_bf_chunk", "fleet_rb_descend",
    "bf_chunk_shard", "fleet_bf_chunk_shard", "fleet_sa_sweeps_shard",
    "fleet_rb_descend_shard",
)

_TRACE_PREFIX = "accel.traces."


class _TraceCounts(MutableMapping):
    """Dict-shaped view over the ``accel.traces.*`` counters.

    Supports exactly what the engine stack uses: ``[k] += 1`` inside
    jitted bodies, iteration/membership (``tuple(TRACE_COUNTS)``), and
    item reads for delta assertions. The key set is fixed; deleting or
    inventing keys is a bug, so both raise.
    """

    def __getitem__(self, k: str) -> int:
        if k not in TRACE_KEYS:
            raise KeyError(k)
        return REGISTRY.counter(_TRACE_PREFIX + k).value

    def __setitem__(self, k: str, v: int) -> None:
        if k not in TRACE_KEYS:
            raise KeyError(k)
        REGISTRY.counter(_TRACE_PREFIX + k).value = int(v)

    def __delitem__(self, k: str) -> None:
        raise TypeError("TRACE_COUNTS keys are fixed")

    def __iter__(self) -> Iterator[str]:
        return iter(TRACE_KEYS)

    def __len__(self) -> int:
        return len(TRACE_KEYS)

    def __contains__(self, k: object) -> bool:
        return k in TRACE_KEYS

    def __repr__(self) -> str:
        return f"TRACE_COUNTS({dict(self)!r})"


#: import this via ``repro.core.accel.eval_jax`` (historic home) or here.
TRACE_COUNTS = _TraceCounts()


# ----------------------------------------------------------------------
# helpers shared by the instrumentation points
# ----------------------------------------------------------------------

@contextmanager
def device_dispatch(kind: str, **attrs: Any):
    """Time one jitted-call dispatch and classify it trace vs cache-hit.

    jax dispatch is asynchronous: the elapsed time of the call is the
    *dispatch* (plus the XLA trace/compile on a cache miss), not the
    device compute — name and read the resulting spans accordingly.
    Classification piggybacks on the ``TRACE_COUNTS`` delta across the
    call: if the counter for ``kind`` grew, this dispatch traced.

    Counters (always on):
      ``accel.dispatches.<kind>``             every call
      ``accel.cache_hits.<kind>``             calls that reused an executable
    plus ``...<kind>[<bucket>]`` variants when a ``bucket`` attr is given
    — the fleet's per-bucket hit/miss ledger.

    A ``accel.dispatch.<kind>`` span is recorded when tracing is on,
    with ``traced=True`` attached on cache misses.
    """
    known = kind in TRACE_KEYS
    before = TRACE_COUNTS[kind] if known else 0
    sp = trace.span(f"accel.dispatch.{kind}", **attrs)
    sp.__enter__()
    try:
        yield sp
    finally:
        # classify BEFORE the span exits so the trace marker lands in
        # the recorded span, not on a dead object
        hit = not (known and TRACE_COUNTS[kind] > before)
        if not hit:
            sp.set(traced=True)
        sp.__exit__(*sys.exc_info())
        bucket = attrs.get("bucket")
        counter(f"accel.dispatches.{kind}").inc()
        if bucket is not None:
            counter(f"accel.dispatches.{kind}[{bucket}]").inc()
        if hit:
            counter(f"accel.cache_hits.{kind}").inc()
            if bucket is not None:
                counter(f"accel.cache_hits.{kind}[{bucket}]").inc()


def note_result(result: Any, *, engine: str = "") -> None:
    """Absorb one finished ``OptimResult`` into the registry.

    Records evaluation counts, the latest points/s gauge, and the
    incumbent-objective-vs-points convergence series for the optimiser
    that produced it. Called once per ``optimise`` return — outside any
    timed region, and purely observational (never mutates ``result``).
    """
    name = str(getattr(result, "name", "unknown"))
    # normalise engine-suffixed names (annealing-jax4 -> annealing)
    base = name.split("-", 1)[0]
    tag = f"{base}[{engine}]" if engine else base
    counter(f"optim.{tag}.runs").inc()
    points = int(getattr(result, "points", 0) or 0)
    seconds = float(getattr(result, "seconds", 0.0) or 0.0)
    counter(f"optim.{tag}.points").inc(points)
    histogram(f"optim.{tag}.seconds").observe(seconds)
    if seconds > 0.0:
        gauge(f"optim.{tag}.points_per_s").set(points / seconds)
    conv = series(f"optim.{tag}.convergence")
    for entry in (getattr(result, "history", None) or ()):
        try:
            x, y = entry[0], entry[1]
            conv.append(float(x), float(y))
        except (TypeError, ValueError, IndexError):
            break


__all__ = [
    "Counter", "Gauge", "Histogram", "Series", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "series", "snapshot", "reset",
    "TRACE_KEYS", "TRACE_COUNTS", "device_dispatch", "note_result",
    "SERIES_CAP",
]
