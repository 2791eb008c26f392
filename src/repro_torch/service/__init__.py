"""Mapping-as-a-service on the card (the port of ``repro.service``).

Public surface:

- :class:`MappingServer` — threaded ``submit()``/future front-end over
  ``optimise_portfolio``'s engine stack, with an stdlib-HTTP adapter
  (``python -m repro_torch.service.server``).
- :class:`SolvedCache` / :class:`SolvedDesign` / :func:`request_key` —
  content-addressed solved-problem cache keyed by the canonical hash of
  the lowered program (``lowering.problem_fingerprint``) plus the
  search configuration.
- :class:`AdmissionQueue` / :func:`run_rule_based_lockstep` — bounded
  admission and dynamic-membership fleet rounds on one device (late
  joiners enter as fresh lanes, early leavers idle as ``cap=0`` no-ops).

A torch request with no card and no ``device="cpu"`` fails fast with
``EngineUnavailable`` on its future; the service never runs it on the CPU
instead.
"""
from repro_torch.service.cache import SolvedCache, SolvedDesign, request_key
from repro_torch.service.queue import (
    AdmissionQueue,
    DeadlineExceeded,
    LockstepJob,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    run_rule_based_lockstep,
)
from repro_torch.service.server import (
    MappingResponse,
    MappingServer,
    serve_http,
)

__all__ = [
    "MappingServer", "MappingResponse", "serve_http",
    "SolvedCache", "SolvedDesign", "request_key",
    "AdmissionQueue", "LockstepJob", "run_rule_based_lockstep",
    "ServiceError", "ServiceOverloaded", "ServiceClosed",
    "DeadlineExceeded",
]
