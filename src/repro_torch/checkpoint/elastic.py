"""Elastic re-meshing: restore any checkpoint onto any mesh factorisation.

Checkpoints store unsharded logical arrays, so elasticity reduces to
placing each leaf with the new plan's sharding. The port runs on one
device: on a mesh of one, ``reshard_tree`` moves every leaf onto that
device; a larger mesh raises, as ``launch/steps.py::shard_fns_from_plan``
does (ROADMAP Queue 1 item 15: sharded steps).
"""
from __future__ import annotations

from typing import Any

import torch


def reshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` on the mesh's one device; ``specs``
    (the leaves' shardings) is kept for the signature: on one device every
    spec places the whole leaf."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"resharding onto a mesh of {mesh.size} devices is not ported "
            f"yet: the port trains on one device (ROADMAP Queue 1 item 15: "
            f"sharded steps)")
    device = mesh.devices.flat[0]

    def put(leaf):
        if isinstance(leaf, dict):
            return {k: put(v) for k, v in leaf.items()}
        if hasattr(leaf, "_fields"):
            return type(leaf)(*(put(v) for v in leaf))
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(put(v) for v in leaf)
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf

    return put(tree)


def shrink_batch_for_mesh(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Elastic shrink keeps per-replica batch constant: the global batch
    scales with the surviving data-parallel degree."""
    per_replica = global_batch // old_dp
    return per_replica * new_dp
