"""Elastic re-meshing: restore any checkpoint onto any mesh factorisation.

Checkpoints store unsharded logical arrays, so elasticity reduces to
placing each leaf with the new plan's sharding. ``reshard_tree`` is also
used live when the runtime shrinks the data-parallel group after a
failure: on a process group's mesh (``launch.mesh.make_mesh``) each leaf
becomes a DTensor laid out from its spec, and a leaf that is a DTensor on
another mesh is gathered and laid out anew. On a mesh of one device with
no group it moves every leaf onto that device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.partition_spec import place_tree


def reshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` placed with its (possibly new)
    ``PartitionSpec`` from ``specs`` (a tree of the same structure; a None
    spec, or ``specs`` None, is replicated), JAX's ``device_put`` with a
    ``NamedSharding``. On a mesh of one device with no process group each
    leaf moves onto that device whole; a mesh of several devices with no
    group is a shape for planning and raises a ``ValueError``."""
    if getattr(mesh, "device_mesh", None) is not None:
        return place_tree(tree, specs, mesh)
    if mesh.size != 1:
        raise ValueError(
            f"a mesh of {mesh.size} devices with no process group behind it "
            f"is a shape for planning; reshard onto launch.mesh.make_mesh")
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
