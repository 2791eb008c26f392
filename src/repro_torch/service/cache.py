"""Content-addressed solved-problem cache of the mapping service (the
port of ``repro.service.cache``).

The key contract has two layers:

  ``lowering.problem_fingerprint``  canonical hash of the lowered
        program: the ``StaticSpec`` plus every array the lowering ships
        to the device — per-node workloads, kind index sets, platform
        scalars, fold-realisability cube, objective flag, amortisation
        factor.
  ``request_key``  sha256 over that fingerprint PLUS the optimiser
        name, the resolved engine and the canonicalised optimiser
        kwargs (``device`` among them) — because the *design* a request
        gets back depends on how it is searched, not only on what is
        searched (the SA generator differs between host and device
        engines, for example).

Equal keys therefore imply bit-identical results from a re-run, which is
what makes serving a cached design indistinguishable from running the
engine: the stored ``Variables`` are re-evaluated through the float64
scalar reference on every hit (``SolvedDesign.to_result``), exactly as a
fresh ``OptimResult`` would be.

The cache itself is a thread-safe LRU with hit/miss/eviction counters
(``service.cache.*``) and an optional JSONL persistence file so a
restarted server starts warm. stdlib + numpy only: it needs no card.
Every statement but this docstring is the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.accel.lowering import problem_fingerprint
from repro_torch.core.hdgraph import Variables
from repro_torch.core.optimizers.common import OptimResult
from repro_torch.obs import metrics as _metrics

__all__ = ["SolvedDesign", "SolvedCache", "request_key"]


def request_key(problem, optimiser: str, engine: str,
                optimiser_kwargs: Optional[dict] = None) -> str:
    """Cache/coalesce key for one mapping request (see module docstring)."""
    kw = sorted((optimiser_kwargs or {}).items())
    h = hashlib.sha256(b"repro.service.request_key.v1")
    h.update(problem_fingerprint(problem).encode())
    h.update(f"|{optimiser}|{engine}|{kw!r}".encode())
    return h.hexdigest()


@dataclass(frozen=True)
class SolvedDesign:
    """The engine-independent half of an ``OptimResult``: everything
    except the ``Evaluation``, which is re-derived from the requesting
    problem on every hit (deterministic, so bit-identical)."""

    cuts: Tuple[int, ...]
    s_in: Tuple[int, ...]
    s_out: Tuple[int, ...]
    kern: Tuple[int, ...]
    points: int
    seconds: float
    history: Tuple[Tuple[int, float], ...]
    name: str

    @classmethod
    def from_result(cls, result: OptimResult) -> "SolvedDesign":
        v = result.variables
        return cls(tuple(v.cuts), tuple(v.s_in), tuple(v.s_out),
                   tuple(v.kern), int(result.points),
                   float(result.seconds),
                   tuple((int(p), float(o)) for p, o in result.history),
                   result.name)

    def to_result(self, problem) -> OptimResult:
        v = Variables(self.cuts, self.s_in, self.s_out, self.kern)
        return OptimResult(v, problem.evaluate(v), self.points,
                           self.seconds, [tuple(e) for e in self.history],
                           name=self.name)

    def to_json(self, key: str) -> dict:
        return {"key": key, "cuts": list(self.cuts),
                "s_in": list(self.s_in), "s_out": list(self.s_out),
                "kern": list(self.kern), "points": self.points,
                "seconds": self.seconds,
                "history": [list(e) for e in self.history],
                "name": self.name}

    @classmethod
    def from_json(cls, rec: dict) -> "SolvedDesign":
        return cls(tuple(rec["cuts"]), tuple(rec["s_in"]),
                   tuple(rec["s_out"]), tuple(rec["kern"]),
                   int(rec["points"]), float(rec["seconds"]),
                   tuple((int(p), float(o)) for p, o in rec["history"]),
                   str(rec["name"]))


class SolvedCache:
    """Bounded LRU of ``request_key -> SolvedDesign``, thread-safe.

    ``path`` enables JSONL persistence: ``load()`` replays the file in
    order (file order IS the LRU order), ``save()`` rewrites it from the
    current contents. Counters: ``service.cache.hits`` / ``.misses`` /
    ``.evictions`` / ``.inserts`` (new keys only) / ``.updates``
    (overwrites of an existing key — these never change the size, so the
    invariant ``inserts - evictions == size`` holds at every point);
    gauge ``service.cache.size``.
    """

    def __init__(self, capacity: int = 512,
                 path: Optional[str] = None) -> None:
        self.capacity = capacity                  # validated by the setter
        self.path = path
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, SolvedDesign]" = OrderedDict()
        if path and os.path.exists(path):
            self.load(path)

    @property
    def capacity(self) -> int:
        return self._capacity

    @capacity.setter
    def capacity(self, value: int) -> None:
        # capacity <= 0 used to slip through post-construction and made
        # ``put`` evict the entry it had just inserted — reject it at
        # every assignment, not only in ``__init__``
        if value < 1:
            raise ValueError(f"capacity must be >= 1, got {value}")
        self._capacity = int(value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        """Membership probe — does NOT touch LRU order or hit counters."""
        with self._lock:
            return key in self._entries

    def get(self, key: str) -> Optional[SolvedDesign]:
        with self._lock:
            design = self._entries.get(key)
            if design is not None:
                self._entries.move_to_end(key)
        if design is None:
            _metrics.counter("service.cache.misses").inc()
        else:
            _metrics.counter("service.cache.hits").inc()
        return design

    def put(self, key: str, design: SolvedDesign) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = design
                _metrics.counter("service.cache.updates").inc()
                _metrics.gauge("service.cache.size").set(
                    len(self._entries))
                return
            self._entries[key] = design
            _metrics.counter("service.cache.inserts").inc()
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                _metrics.counter("service.cache.evictions").inc()
            _metrics.gauge("service.cache.size").set(len(self._entries))

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no persistence path configured")
        with self._lock:
            items = list(self._entries.items())
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for key, design in items:          # oldest-first = LRU order
                f.write(json.dumps(design.to_json(key)) + "\n")
        return path

    def load(self, path: Optional[str] = None) -> int:
        """Merge a JSONL file into the cache (newest lines win LRU
        recency); returns the number of records read."""
        path = path or self.path
        if not path:
            raise ValueError("no persistence path configured")
        n = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                self.put(rec["key"], SolvedDesign.from_json(rec))
                n += 1
        return n
