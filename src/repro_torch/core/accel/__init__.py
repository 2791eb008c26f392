"""Device engine of the port: the Table-IV hot path on a CUDA card.

  lowering.py      BatchedEvaluator flat numpy arrays -> ``DeviceTensors``
                   (torch tensors on the engine's device) + a hashable
                   ``StaticSpec``; the node axis can be padded bit-neutrally.
  segred.py        the partition-time segmented reduction: wrapper of the
                   hand-written CUDA kernel (``csrc/segred.cu``) and its
                   plain PyTorch version.
  eval_torch.py    the batched evaluate array program (``_eval_core``).
  search_loops.py  the optimisers' device search: brute-force chunk decode
                   and evaluation, the multi-chain SA sweep loop, and the
                   rule-based greedy descent as a host loop over one
                   device step per move. Every body takes a leading
                   problem ("lane") axis; one problem is the P = 1 case.
  fleet.py         multi-problem sweeps: bucket problems by program shape,
                   pad and stack their device tensors, and run the
                   brute-force chunks / SA sweeps / rule-based descents of
                   a whole bucket as one lane-stacked pass (one segred
                   launch a step), per-problem results bitwise those of
                   the per-problem loop (``pipeline.optimise_portfolio``).

Engine registry
---------------
  scalar   the one-design-at-a-time reference (perfmodel.py)
  numpy    the vectorised host array program (batched_eval.py)
  torch    this package, on ``cuda`` (``device="cpu"`` on request)

``auto`` resolves to ``torch``. Unknown names raise ``ValueError``; a torch
engine with no card and no ``device="cpu"`` raises ``EngineUnavailable``
(``runtime.default_device``).
"""
from __future__ import annotations

import importlib.util

ENGINES = ("scalar", "numpy", "torch")

#: legacy / convenience aliases accepted everywhere an engine name is
_ALIASES = {"batched": "numpy", "auto": "torch"}


class EngineUnavailable(RuntimeError):
    """A search engine was requested that this environment cannot run."""


def torch_available() -> bool:
    """True when torch is importable (the card is checked separately, by
    ``runtime.default_device``)."""
    return importlib.util.find_spec("torch") is not None


def resolve_engine(name: str) -> str:
    """Normalise an engine name; ``auto`` is ``torch``. No fallback: an
    unavailable engine raises."""
    name = _ALIASES.get(name, name)
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; known: "
                         f"{ENGINES + tuple(_ALIASES)}")
    if name == "torch" and not torch_available():
        raise EngineUnavailable("engine='torch' requires torch, which is "
                                "not installed")
    return name


__all__ = ["ENGINES", "EngineUnavailable", "torch_available",
           "resolve_engine"]
