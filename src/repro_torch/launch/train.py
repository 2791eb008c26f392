"""The SAMO plan for a training or serving cell on a mesh.

Only ``plan_for_mesh`` is ported; the training loop (data, AdamW,
checkpoints, restarts) is ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.backends import BACKENDS
from repro_torch.core.exporter import ShardingPlan, export_plan
from repro_torch.core.graph_builder import build_hdgraph
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers import rule_based
from repro_torch.core.perfmodel import ModelOptions
from repro_torch.core.platform import Platform


def plan_for_mesh(arch: ArchConfig, shape: ShapeSpec, mesh,
                  objective: str = "latency", zero1: bool = True,
                  time_budget_s: float = 20.0) -> ShardingPlan:
    """The JAX package's ``plan_for_mesh``: the rule-based optimiser on an
    spmd problem over ``mesh``'s axes, exported as a ``ShardingPlan``.
    The search runs on the port's torch engine on the mesh's first device
    (the card for a planning mesh, which holds none)."""
    axes = tuple(zip(mesh.axis_names, mesh.devices.shape))
    platform = Platform(name="train", mesh_axes=axes)
    graph = build_hdgraph(arch, shape)
    problem = Problem(graph=graph, platform=platform,
                      backend=BACKENDS["spmd"], objective=objective,
                      exec_model="spmd", opts=ModelOptions(zero1=zero1))
    result = rule_based(problem, time_budget_s=time_budget_s,
                        device=mesh.devices.flat[0])
    return export_plan(graph, result.variables, platform, "spmd",
                       result.evaluation)


__all__ = ["plan_for_mesh"]
