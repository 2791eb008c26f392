"""End-to-end training loop.

Wires together: SAMO mapping (core/pipeline) -> step functions (steps.py) ->
data pipeline -> AdamW -> atomic checkpointing with restart-from-latest ->
straggler tracking, on one device: the card unless the caller asks for the
CPU (``device="cpu"``, which runs the plain versions of the kernels).

The port's counterpart of the JAX package's ``launch/train.py``. The model
is ``Model(arch, attn_impl="chunked")`` (JAX's choice: the flash kernels
have no backward), its weights drawn from a ``torch.Generator`` seeded
``seed``. A checkpoint holds ``{"params", "opt"}`` in the JAX package's
tree and on-disk layout, so either package can resume the other's run.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.backends import BACKENDS
from repro_torch.core.exporter import ShardingPlan, export_plan
from repro_torch.core.graph_builder import build_hdgraph
from repro_torch.core.objectives import Problem
from repro_torch.core.optimizers import rule_based
from repro_torch.core.perfmodel import ModelOptions
from repro_torch.core.platform import Platform
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import flatten, nest
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.runtime.stragglers import StragglerTracker


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


@dataclasses.dataclass
class TrainLoopResult:
    steps_run: int
    final_loss: float
    losses: list
    restarts: int
    tokens_per_second: float
    #: wall seconds of each step run, batch included (the straggler
    #: tracker's input; each ends in the host read of the step's loss)
    step_seconds: list = dataclasses.field(default_factory=list)


def checkpoint_tree(model: Model, opt_state: AdamWState) -> Dict[str, Any]:
    """``{"params", "opt"}`` as the JAX package's train loop saves it: the
    parameter tree and an ``AdamWState`` of trees, nested by the
    ``state_dict`` keys' parts (leaf paths ``params/dec0/p0_attn/wq``,
    ``opt/master/...``, ``opt/step``)."""
    return {"params": nest({k: p.detach()
                            for k, p in model.named_parameters()}),
            "opt": AdamWState(opt_state.step, nest(opt_state.master),
                              nest(opt_state.m), nest(opt_state.v))}


def restore_tree(model: Model, tree: Dict[str, Any]) -> AdamWState:
    """Loads a ``checkpoint_tree`` into ``model``'s parameters; returns the
    optimiser state keyed as the ``state_dict``."""
    with torch.no_grad():
        model.load_state_dict(flatten(tree["params"]), strict=True)
    opt = tree["opt"]
    return AdamWState(opt.step, flatten(opt.master), flatten(opt.m),
                      flatten(opt.v))


def train(arch: ArchConfig, *, steps: int = 100, seq_len: int = 256,
          global_batch: int = 8, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_interval: int = 50,
          mesh=None, zero1: bool = True, seed: int = 0,
          log_every: int = 10, resume: bool = True,
          log=print, device=None) -> TrainLoopResult:
    """JAX's ``train``, on ``mesh`` (default: the host mesh of ``device``,
    which is the card unless ``"cpu"`` is asked; no card raises
    ``EngineUnavailable``)."""
    mesh = mesh or make_host_mesh(device)
    dev = mesh.devices.flat[0]
    shape = ShapeSpec("train_custom", seq_len, global_batch, "train")
    plan = plan_for_mesh(arch, shape, mesh, zero1=zero1)
    model = Model(arch, attn_impl="chunked", device=dev,
                  generator=torch.Generator(dev).manual_seed(seed))

    step_fn = make_train_step(
        model, plan, mesh, lr=lr, zero1=zero1,
        batch_keys=("tokens", "labels"),
        dp_axes=plan.dp_axes(0) or ("data",))

    opt_state = adamw_init(dict(model.named_parameters()))
    pipeline = DataPipeline(arch.vocab_size, seq_len, global_batch,
                            seed=seed, device=dev)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir, ckpt_interval) if ckpt_dir else None
    if mgr is not None and resume:
        restored = mgr.restore_or_none(like=checkpoint_tree(model,
                                                            opt_state))
        if restored is not None:
            start_step, tree, extra = restored
            opt_state = restore_tree(model, tree)
            pipeline.skip_to(start_step)        # O(1), no data replay
            log(f"[train] resumed from step {start_step}")
    pipeline.skip_to(start_step)

    tracker = StragglerTracker()
    losses, step_seconds = [], []
    t0 = time.time()
    for step in range(start_step, steps):
        ts = time.time()
        batch = pipeline.next_batch()
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        step_seconds.append(time.time() - ts)
        tracker.record("host0", step_seconds[-1])
        if mgr is not None:
            mgr.maybe_save(step + 1, checkpoint_tree(model, opt_state),
                           extra={"loss": loss})
        if (step + 1) % log_every == 0:
            log(f"[train] step {step+1:5d}  loss {loss:.4f}  "
                f"{(time.time()-ts)*1e3:.0f} ms/step")
    wall = time.time() - t0
    tps = (steps - start_step) * global_batch * seq_len / max(wall, 1e-9)
    return TrainLoopResult(steps - start_step, losses[-1] if losses else
                           float("nan"), losses, 0, tps, step_seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    res = train(arch, steps=args.steps, seq_len=args.seq,
                global_batch=args.batch, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
                device=args.device)
    print(f"[train] done: {res.steps_run} steps, final loss "
          f"{res.final_loss:.4f}, {res.tokens_per_second:.0f} tok/s")
    return 0


__all__ = ["plan_for_mesh", "TrainLoopResult", "train", "main",
           "checkpoint_tree", "restore_tree"]


if __name__ == "__main__":
    sys.exit(main())
