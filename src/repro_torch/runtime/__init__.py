"""Device and precision policy of the port.

``default_device()`` is ``cuda``; with no card it raises
``EngineUnavailable`` and never falls back to the CPU. A caller that wants
the CPU says so (``device="cpu"``), and then every kernel wrapper takes its
plain PyTorch version.

``device_mesh(devices, device)`` lists the devices of the D shards that a
``devices=D`` search runs, in shard order (the counterpart of the JAX
package's ``runtime_config.device_mesh``). The shards are driven from the
host, so several may share one device: on one card they run one after
another.

Floats are float32 by default (the JAX engine's dtype without x64) and
float64 on request. Importing this module pins float32 matmuls to full
precision: ``_eval_core``'s one-hot segment sums are einsums, and TF32 keeps
about three decimal digits, which would break the float32 contract.

The package also holds verbatim copies of the JAX package's host runtime:
``fault_tolerance`` (heartbeats, the restart / elastic-shrink / abort
policy) and ``stragglers`` (per-host step times against a deadline).
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from repro_torch.core.accel import EngineUnavailable

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

FLOAT_DTYPES = (torch.float32, torch.float64)


def default_device() -> torch.device:
    """The card. Raises ``EngineUnavailable`` when none is visible."""
    if not torch.cuda.is_available():
        raise EngineUnavailable(
            "the torch engine runs on a CUDA card and none is visible; pass "
            "device='cpu' to run the kernels' plain versions on the CPU, or "
            "select engine='numpy' / engine='scalar'")
    return torch.device("cuda")


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card; anything else is taken as asked."""
    return default_device() if device is None else torch.device(device)


def device_mesh(devices: int,
                device: Union[None, str, torch.device] = None
                ) -> List[torch.device]:
    """The devices of the D = ``devices`` shards of a sharded search, in
    shard order.

    ``device=None``: shard d runs on ``cuda:(d % cards)``, so D shards
    spread over the visible cards and, where D exceeds them, share them.
    With no card it raises ``EngineUnavailable``. An explicit ``device``
    holds every shard (``device="cpu"``: D logical CPU shards).
    ``devices < 1`` raises ``ValueError``."""
    if int(devices) < 1:
        raise ValueError(f"device_mesh needs >= 1 device, got {devices}")
    if device is None:
        default_device()
        cards = torch.cuda.device_count()
        return [torch.device("cuda", d % cards) for d in range(int(devices))]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * int(devices)


def resolve_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    return dtype


from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultToleranceConfig,
    HeartbeatMonitor,
    ResilientRunner,
)
from repro_torch.runtime.stragglers import StragglerTracker  # noqa: E402

__all__ = ["default_device", "resolve_device", "device_mesh",
           "resolve_dtype", "FLOAT_DTYPES", "FaultToleranceConfig",
           "HeartbeatMonitor", "ResilientRunner", "StragglerTracker"]
