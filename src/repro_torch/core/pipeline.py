"""End-to-end SAMO pipeline of the port: parse -> optimise -> export.

    plan = optimise_mapping(arch, shape, platform, backend="spmd",
                            optimiser="rule_based", objective="throughput",
                            engine="torch")

The same entry point as ``repro.core.pipeline.optimise_mapping``. Engines:

  engine   brute_force           annealing             rule_based
  -------  --------------------  --------------------  --------------------
  scalar   one point at a time   one chain (or         scalar probe loop
           (reference)           tempering), host      (reference)
  numpy    chunked host batches  tempering, one batch  each greedy step's
                                 a sweep, host         probes as one batch
  torch    chunk decode and      multi-chain sweeps    each greedy step on
           evaluation on the     on the card, one      the card
           card, one readback    readback a block
           a chunk

``torch`` is the default, and ``auto`` resolves to it.

On the card the partition-time reduction of every candidate with a cut
runs in the hand-written segred kernel. Brute force's torch engine returns
the numpy engine's optimum, point count and history; rule-based walks the
scalar reference's move sequence; annealing is deterministic for a seed.
``annealing`` also takes ``engine="host"`` (the host engines by chain
count).

The torch engine runs on ``cuda``; ``device="cpu"`` (an optimiser kwarg)
runs it on the CPU with the kernels' plain versions. With no card and no
``device="cpu"`` it raises ``EngineUnavailable``. Returned ``Evaluation``
objects are always re-derived through the float64 scalar reference.

Portfolios (ROADMAP Queue 1, item 7), the ``devices=`` axis (item 9),
co-mapping (item 10) and the baseline plan are still to port;
``brute_force(devices=...)`` raises ``NotImplementedError`` naming item 9.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.backends import BACKENDS
from repro_torch.core.exporter import ShardingPlan, export_plan
from repro_torch.core.graph_builder import build_hdgraph
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.perfmodel import ModelOptions
from repro_torch.core.platform import Platform, V5E_POD
from repro_torch.obs import trace as _trace


def make_problem(arch: ArchConfig, shape: ShapeSpec,
                 platform: Platform = V5E_POD,
                 backend: str = "spmd",
                 objective: str = "throughput",
                 exec_model: str = "streaming",
                 opts: Optional[ModelOptions] = None,
                 **model_opts) -> Problem:
    """``model_opts`` are ModelOptions fields (zero1=True, ...) used when no
    explicit ``opts`` is given."""
    if opts is not None and model_opts:
        raise TypeError(f"pass either opts= or ModelOptions fields "
                        f"{sorted(model_opts)}, not both")
    graph = build_hdgraph(arch, shape)
    return Problem(
        graph=graph,
        platform=platform,
        backend=BACKENDS[backend],
        objective=objective,
        exec_model=exec_model,
        opts=opts or ModelOptions(**model_opts),
    )


def optimise_mapping(arch: ArchConfig, shape: ShapeSpec,
                     platform: Platform = V5E_POD,
                     backend: str = "spmd",
                     optimiser: str = "rule_based",
                     objective: str = "throughput",
                     exec_model: str = "streaming",
                     opts: Optional[ModelOptions] = None,
                     engine: Optional[str] = None,
                     **optimiser_kwargs) -> ShardingPlan:
    """``engine`` selects the evaluation engine (see the module docstring);
    None keeps the optimiser's default (torch). Remaining kwargs go to the
    optimiser entry point (``device=`` among them)."""
    if optimiser not in OPTIMIZERS:
        raise ValueError(f"unknown optimiser {optimiser!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    with _trace.span("pipeline.optimise_mapping", arch=arch.name,
                     optimiser=optimiser, backend=backend,
                     objective=objective, engine=engine or "default"):
        with _trace.span("pipeline.make_problem"):
            problem = make_problem(arch, shape, platform, backend,
                                   objective, exec_model, opts)
        if engine is not None:
            optimiser_kwargs["engine"] = engine
        with _trace.span("pipeline.optimise", optimiser=optimiser):
            result = OPTIMIZERS[optimiser](problem, **optimiser_kwargs)
        with _trace.span("pipeline.export_plan"):
            return export_plan(problem.graph, result.variables, platform,
                               exec_model, result.evaluation)


__all__ = ["make_problem", "optimise_mapping"]
