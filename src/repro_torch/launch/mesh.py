"""Meshes of the port.

A ``Mesh`` is what the planner and the launch layer read of a mesh: its
axis names, an array of devices whose shape is the mesh's shape and the
size of each axis by name (JAX's ``mesh.axis_names``,
``mesh.devices.shape`` and ``mesh.shape``), and, where a process group
stands behind it, the ``torch.distributed`` ``DeviceMesh`` that the
sharded steps place their DTensors on (``device_mesh``).

  make_host_mesh        the 1 x 1 mesh of one device (the card, or the
                        CPU when asked), no process group: the steps run
                        on plain tensors
  make_production_mesh  the TPU pod's shape (16 x 16, or 2 x 16 x 16) with
                        no devices behind it, for planning only
  init_process_group    a process group of ``world_size`` ranks: ``nccl``
                        on cards, ``gloo`` only when the caller asks for
                        the CPU
  init_fake_group       the ``fake`` backend's group of 512 ranks in one
                        process (no communication), for the dry run
  make_mesh             a mesh of ``shape`` over ranks 0 .. prod(shape) - 1
                        of the process's group
  make_fake_mesh        the production mesh's shape on the fake group: one
                        512-rank group serves the 16 x 16 mesh (ranks
                        0-255) and the 2 x 16 x 16 one, since a process
                        initialises one group
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.runtime import resolve_device

#: ranks of the dry run's fake group: the 2 x 16 x 16 mesh's
FAKE_WORLD = 512


@dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: Tuple[str, ...]
    #: an object array of ``torch.device`` (None: a shape for planning)
    devices: np.ndarray
    #: the ``DeviceMesh`` of a process group (None: no group behind it)
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name to size, in axis order (JAX's ``mesh.shape``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))


def _grid(shape, fill) -> np.ndarray:
    grid = np.empty(shape, dtype=object)
    grid.fill(fill)
    return grid


def _axes_of(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16 x 16 (or 2 x 16 x 16) pod mesh's axes and shape, with no
    devices: for planning."""
    shape, axes = _axes_of(multi_pod)
    return Mesh(axes, _grid(shape, None))


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1 x 1 mesh of one device: the card unless ``device``
    says otherwise (``runtime.resolve_device``)."""
    return Mesh(("data", "model"), _grid((1, 1), resolve_device(device)))


def init_process_group(world_size: int, rank: int = 0, *, device=None,
                       init_method: Optional[str] = None) -> None:
    """Joins this process to a group of ``world_size`` ranks as ``rank``:
    ``nccl`` when ``device`` is the card (the default; no card raises
    ``EngineUnavailable``), ``gloo`` when it is ``"cpu"``. ``init_method``
    is the rendezvous (``tcp://localhost:<port>`` or ``file://<path>``);
    None reads ``MASTER_ADDR`` / ``MASTER_PORT``."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=int(world_size), rank=int(rank))


def init_fake_group(world_size: int = FAKE_WORLD) -> None:
    """The ``fake`` backend's group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing, so one process
    can build and run a step of any mesh with fake tensors. Does nothing
    when this process already has a fake group that large."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and \
                dist.get_world_size() >= world_size:
            return
        raise RuntimeError(
            f"this process already has a {dist.get_backend()} group of "
            f"{dist.get_world_size()} ranks; the fake group of {world_size} "
            f"needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))


def make_mesh(shape, axis_names, *, device=None) -> Mesh:
    """The mesh of ``shape`` (axis sizes, in the order of ``axis_names``)
    over ranks 0 .. prod(shape) - 1 of this process's group, which must
    have at least that many ranks. ``device``: where this rank computes
    (default: the card; ``"cpu"`` for a gloo or fake group on the CPU)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: "
                           "init_process_group or init_fake_group first")
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    dev = resolve_device(device)
    dm = DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axis_names)
    return Mesh(axis_names, _grid(shape, dev), dm)


def make_fake_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh's shape over the 512-rank fake group (made here
    if this process has none): the dry run's mesh."""
    init_fake_group()
    shape, axes = _axes_of(multi_pod)
    return make_mesh(shape, axes, device=device)


__all__ = ["Mesh", "FAKE_WORLD", "make_host_mesh", "make_production_mesh",
           "init_process_group", "init_fake_group", "make_mesh",
           "make_fake_mesh"]
