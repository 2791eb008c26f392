"""The port's ``PartitionSpec``: how each dimension of a tensor is sharded
over the axes of a mesh.

A spec is a tuple with one entry a dimension, from the first on: ``None``
(the dimension is not sharded), a mesh axis name, or a tuple of axis names
(sharded over their product). Dimensions past its length are not sharded;
``PartitionSpec()`` shards nothing. It compares, hashes, indexes and has a
length as the tuple of its entries does, as ``jax.sharding.PartitionSpec``
does: ``PartitionSpec("data", None) == ("data", None)`` and
``!= PartitionSpec("data")``.

The planner emits these (``core/exporter.py``: ``ShardingPlan.data_spec``,
``act_spec``, ``spec_for_role``, ``kv_cache_spec``), and the model and
the launch layer build the parameter, cache, batch and optimiser-state
trees of them (``Model.param_specs`` / ``cache_specs``,
``launch/steps.py``). On one device every spec places the whole tensor.
On a process group's mesh (``launch/mesh.make_mesh``) ``placements``
turns a spec into DTensor placements, ``place`` / ``place_tree`` lay
tensors out by their specs and ``constrain`` redistributes a DTensor to
a spec (JAX's ``with_sharding_constraint``).
"""
from __future__ import annotations

from typing import Any


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``; each entry ``None``, an axis name or a
    tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


def _entry_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, axis_names, shape=None, axis_sizes=None):
    """The DTensor placements of ``spec`` on a mesh of ``axis_names``: one
    a mesh dimension, ``Shard(d)`` on each mesh dimension that tensor
    dimension ``d``'s entry names, ``Replicate()`` on the others (``None``
    is a spec that shards nothing).

    An entry of several axes shards its dimension over their product,
    major to minor in the tuple's order, as JAX does; DTensor shards a
    dimension in mesh-dimension order, so the tuple must list its axes in
    mesh order (the exporter sorts them so), or a ``ValueError`` is
    raised. An uneven dimension shards as JAX's does: shards of
    ceil(n / k) rows, the last short (``torch.chunk``'s). Over several
    axes DTensor chunks a chunk, which differs from JAX's ceil(n / (a b))
    where n is not a multiple of the product, so given ``shape`` and
    ``axis_sizes`` (name to size) that case raises a ``ValueError`` too.
    A mesh axis named twice raises, as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in axis_names]
    seen = set()
    for d, entry in enumerate(spec if spec is not None else ()):
        axes = _entry_axes(entry)
        dims = []
        for a in axes:
            if a not in axis_names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in "
                                 f"{tuple(axis_names)}")
            if a in seen:
                raise ValueError(f"{spec}: mesh axis {a!r} named twice")
            seen.add(a)
            dims.append(axis_names.index(a))
        if dims != sorted(dims):
            raise ValueError(
                f"{spec}: dimension {d} lists the axes {axes} against the "
                f"mesh's order {tuple(axis_names)}; DTensor would shard it "
                f"minor to major")
        if len(dims) > 1 and shape is not None and axis_sizes is not None:
            k = 1
            for a in axes:
                k *= axis_sizes[a]
            if shape[d] % k:
                raise ValueError(
                    f"{spec}: dimension {d} of {shape[d]} over {axes} "
                    f"({k} shards) is uneven, and DTensor's nested chunks "
                    f"would differ from JAX's shards")
        for m in dims:
            out[m] = Shard(d)
    return out


def constrain(a, mesh, spec):
    """``a`` laid out as ``spec`` on ``mesh``'s ``DeviceMesh`` (JAX's
    ``with_sharding_constraint``): a DTensor is redistributed, a plain
    tensor (the same on every rank) placed."""
    from torch.distributed.tensor import DTensor, Replicate

    dm = mesh.device_mesh
    pl = placements(spec, mesh.axis_names)
    if not isinstance(a, DTensor):
        a = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    if tuple(a.placements) == tuple(pl):
        return a
    return a.redistribute(dm, pl)


def place(t, spec, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor laid out as
    ``spec`` (None: replicated) on ``mesh``'s ``DeviceMesh``: each rank
    keeps its own shard, with no communication. A DTensor already on a
    mesh is redistributed to the layout (on another mesh: gathered
    first)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dm = mesh.device_mesh
    if isinstance(t, DTensor):
        if t.device_mesh != dm:
            t = t.full_tensor()
        else:
            return constrain(t, mesh, spec)
    pl = placements(spec, mesh.axis_names, tuple(t.shape), mesh.shape)
    return distribute_tensor(t, dm, pl, src_data_rank=None)


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """``place`` over the leaves of nested dicts, named tuples, tuples and
    lists of tensors, ``specs`` a tree of the same structure (a spec a
    leaf) or None (everything below replicated); leaves that are not
    tensors stay as they are."""
    if isinstance(tree, dict):
        return {k: place_tree(v, None if specs is None else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        subs = [None] * len(tree) if specs is None else specs
        items = [place_tree(v, s, mesh) for v, s in zip(tree, subs)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return place(tree, specs, mesh)
    return tree


__all__ = ["PartitionSpec", "P", "placements", "constrain", "place",
           "place_tree"]
