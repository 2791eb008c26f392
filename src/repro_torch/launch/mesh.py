"""Meshes of the port.

A ``Mesh`` is what the planner and the launch layer read of a mesh: its
axis names, an array of devices whose shape is the mesh's shape and the
size of each axis by name (JAX's ``mesh.axis_names``,
``mesh.devices.shape`` and ``mesh.shape``). The port runs on one
card: ``make_host_mesh`` is the 1 x 1 mesh of that card, and
``make_production_mesh`` the TPU pod's shape with no devices behind it,
for planning only.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.runtime import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: Tuple[str, ...]
    #: an object array of ``torch.device`` (None: a shape for planning)
    devices: np.ndarray

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16 x 16 (or 2 x 16 x 16) pod mesh's axes and shape, with no
    devices: for planning."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, _grid(shape, None))


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1 x 1 mesh of one device: the card unless ``device``
    says otherwise (``runtime.resolve_device``)."""
    return Mesh(("data", "model"), _grid((1, 1), resolve_device(device)))


__all__ = ["Mesh", "make_host_mesh", "make_production_mesh"]
