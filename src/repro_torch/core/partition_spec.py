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
"""
from __future__ import annotations


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

__all__ = ["PartitionSpec", "P"]
