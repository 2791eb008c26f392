"""Engine telemetry of the port: spans (``trace.py``) and the metrics
registry (``metrics.py``), copies of ``repro.obs``'s two stdlib-only
modules. The port's registry is its own: ``repro.obs`` never sees the
port's spans or counters."""
from __future__ import annotations

from repro_torch.obs import metrics, trace

__all__ = ["trace", "metrics"]
