"""Fault-tolerance runtime: heartbeats, restart policy, elastic shrink.

On a real pod, each host runs a HeartbeatMonitor fed by its neighbours'
liveness (DCN side-channel); the coordinator applies the policy below. This
container is single-host, so the same control logic is driven by injected
failure events in tests — the decisions (restart-from-checkpoint vs elastic
shrink vs abort) are what we validate.

Policy:
  - a host missing `miss_limit` heartbeats is declared failed;
  - if spare capacity exists -> full restart from the latest checkpoint on
    the same mesh (steps since the checkpoint are replayed; the data pipeline
    skip_to makes the stream identical);
  - else -> ELASTIC SHRINK: drop the failed host's data-parallel replica,
    reshard the checkpoint onto the surviving mesh (checkpoint/elastic.py),
    scale the global batch, continue;
  - more than `max_restarts` restarts within `window_s` -> abort (crash-loop
    guard).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class FaultToleranceConfig:
    heartbeat_interval_s: float = 10.0
    miss_limit: int = 3
    max_restarts: int = 5
    window_s: float = 3600.0
    allow_elastic: bool = True


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], cfg: FaultToleranceConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last_seen: Dict[str, float] = {h: clock() for h in hosts}

    def beat(self, host: str, at: Optional[float] = None) -> None:
        self.last_seen[host] = self.clock() if at is None else at

    def failed_hosts(self) -> List[str]:
        now = self.clock()
        limit = self.cfg.heartbeat_interval_s * self.cfg.miss_limit
        return [h for h, t in self.last_seen.items() if now - t > limit]

    def remove(self, host: str) -> None:
        self.last_seen.pop(host, None)


@dataclass
class RestartEvent:
    at: float
    kind: str                  # restart | shrink | abort
    detail: str = ""


class ResilientRunner:
    """Drives a step function under the FT policy. The step function and the
    checkpoint manager are injected, so the full decision logic is testable
    on one host."""

    def __init__(self, cfg: FaultToleranceConfig, monitor: HeartbeatMonitor,
                 checkpoint_mgr, spare_hosts: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.monitor = monitor
        self.ckpt = checkpoint_mgr
        self.spare_hosts = spare_hosts
        self.clock = clock
        self.events: List[RestartEvent] = []

    def _recent_restarts(self) -> int:
        cutoff = self.clock() - self.cfg.window_s
        return sum(1 for e in self.events
                   if e.kind in ("restart", "shrink") and e.at > cutoff)

    def handle_failures(self) -> Optional[str]:
        """Returns the action taken ('restart' | 'shrink' | 'abort' | None)."""
        failed = self.monitor.failed_hosts()
        if not failed:
            return None
        if self._recent_restarts() >= self.cfg.max_restarts:
            self.events.append(RestartEvent(self.clock(), "abort",
                                            f"crash loop: {failed}"))
            return "abort"
        if self.spare_hosts >= len(failed):
            self.spare_hosts -= len(failed)
            for h in failed:
                self.monitor.remove(h)
            self.events.append(RestartEvent(self.clock(), "restart",
                                            f"replaced {failed}"))
            return "restart"
        if self.cfg.allow_elastic:
            for h in failed:
                self.monitor.remove(h)
            self.events.append(RestartEvent(self.clock(), "shrink",
                                            f"dropped {failed}"))
            return "shrink"
        self.events.append(RestartEvent(self.clock(), "abort",
                                        f"no spare capacity for {failed}"))
        return "abort"
