"""Straggler mitigation: per-host step-time tracking with a p99 deadline.

A host whose step time exceeds ``deadline_factor`` x the rolling p50 for
``patience`` consecutive steps is flagged; the runner treats a flagged host
like a soft failure (pre-emptive restart/shrink before it stalls the
collective). Deterministic and unit-testable.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List


@dataclass
class StragglerTracker:
    window: int = 50
    deadline_factor: float = 3.0
    patience: int = 3

    _times: Dict[str, Deque[float]] = field(default_factory=dict)
    _strikes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def record(self, host: str, step_time_s: float) -> None:
        dq = self._times.setdefault(host, deque(maxlen=self.window))
        dq.append(step_time_s)
        med = self.global_median()
        if med > 0 and step_time_s > self.deadline_factor * med:
            self._strikes[host] += 1
        else:
            self._strikes[host] = 0

    def global_median(self) -> float:
        all_times = sorted(t for dq in self._times.values() for t in dq)
        if not all_times:
            return 0.0
        return all_times[len(all_times) // 2]

    def stragglers(self) -> List[str]:
        return [h for h, s in self._strikes.items() if s >= self.patience]

    def deadline_s(self) -> float:
        """Collective timeout the runner arms per step."""
        med = self.global_median()
        return self.deadline_factor * med if med > 0 else float("inf")
