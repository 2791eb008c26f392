"""Target platform description (the FPGA-device analogue).

The paper's platform triple (resource vector, bandwidth, reconfiguration time)
maps to a TPU pod slice: per-chip HBM capacity, HBM/ICI/DMA bandwidths, and
the weight-streaming swap bandwidth that defines ``t_conf``.

Hardware constants follow the assignment brief: 197 TFLOP/s bf16 per chip,
819 GB/s HBM, ~50 GB/s per ICI link.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence, Tuple


@functools.lru_cache(maxsize=64)
def _realizable_folds(mesh_axes: Tuple[Tuple[str, int], ...]
                      ) -> Dict[int, List[FrozenSet[str]]]:
    out: Dict[int, List[FrozenSet[str]]] = {}
    names = tuple(n for n, _ in mesh_axes)
    sizes = dict(mesh_axes)
    for r in range(len(names) + 1):
        for combo in itertools.combinations(names, r):
            prod = 1
            for a in combo:
                prod *= sizes[a]
            out.setdefault(prod, []).append(frozenset(combo))
    return out


@functools.lru_cache(maxsize=200_000)
def _assign_axes(mesh_axes: Tuple[Tuple[str, int], ...],
                 folds: Tuple[int, ...]):
    table = _realizable_folds(mesh_axes)
    chosen: List[FrozenSet[str]] = []

    def rec(i: int, used: FrozenSet[str]) -> bool:
        if i == len(folds):
            return True
        f = folds[i]
        for subset in sorted(table.get(f, []), key=lambda s: sorted(s)):
            if subset & used:
                continue
            chosen.append(subset)
            if rec(i + 1, used | subset):
                return True
            chosen.pop()
        return False

    ok = rec(0, frozenset())
    return (tuple(chosen), ok) if ok else ((), False)


@dataclass(frozen=True)
class Platform:
    name: str = "tpu-v5e-256"
    # mesh axes as ((name, size), ...) — must match launch/mesh.py
    mesh_axes: Tuple[Tuple[str, int], ...] = (("data", 16), ("model", 16))
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    hbm_bytes: float = 16 * 2**30       # per chip
    ici_bw: float = 50e9                # bytes/s per link (roofline convention)
    dma_bw: float = 6.25e9              # host->HBM bytes/s per chip (weight streaming)
    reconf_fixed_s: float = 0.010       # per-swap overhead: program switch +
                                        # global barrier + DMA ramp (the TPU
                                        # analogue of the FPGA bitstream load)
    vmem_bytes: float = 128 * 2**20     # per core, Pallas working-set budget

    @property
    def chips(self) -> int:
        n = 1
        for _, s in self.mesh_axes:
            n *= s
        return n

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.mesh_axes)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.mesh_axes)

    # ------------------------------------------------------------------
    # Mesh-realisable folds: a folding factor is realisable iff it is the
    # product of a subset of mesh-axis sizes (the TPU channel-factor rule).
    # ------------------------------------------------------------------
    def realizable_folds(self) -> Dict[int, List[FrozenSet[str]]]:
        """fold value -> list of axis subsets achieving it (memoised)."""
        return _realizable_folds(self.mesh_axes)

    def fold_values(self) -> List[int]:
        return sorted(self.realizable_folds())

    def assign_axes(
        self, folds: Sequence[int]
    ) -> Tuple[Tuple[FrozenSet[str], ...], bool]:
        """Assign disjoint mesh-axis subsets realising each fold in `folds`.

        Returns (assignment, ok). The product of all folds must not exceed
        the mesh, and every fold must map to its own disjoint axis subset.
        Deterministic: earlier folds get first pick in sorted-subset order.
        Memoised — the optimiser probes the same triples millions of times.
        """
        return _assign_axes(self.mesh_axes, tuple(folds))

    def folds_realizable(self, folds: Sequence[int]) -> bool:
        return self.assign_axes(folds)[1]


# ----------------------------------------------------------------------
# Resource splitting (multi-network co-mapping, docs/comapping.md)
# ----------------------------------------------------------------------

def split_axis0(platform: Platform, parts: Sequence[int],
                check_budget: bool = True) -> Tuple[Platform, ...]:
    """Carve disjoint sub-platforms out of ``platform`` along mesh axis 0.

    ``parts[i]`` is net ``i``'s contiguous chunk of the leading mesh axis;
    the remaining axes are inherited whole, so every sub-platform is a
    real sub-mesh and its fold menu / realisability tables follow from
    the ordinary ``Platform`` rules. Chips are disjoint by construction,
    hence each net's aggregate HBM budget is exactly
    ``sub.chips * hbm_bytes`` — splitting the chip budget splits the HBM
    budget with it. Per-chip scalars (bandwidths, vmem) are physical
    properties of a chip and are inherited unchanged.

    Raises ``ValueError`` for non-positive chunks or when the chunks
    overcommit the axis. ``check_budget=False`` skips only the
    overcommit raise so ``CoMapProblem`` can defer the shared-budget
    constraint into the candidate (``budget_violations`` marks such
    splits infeasible instead of the constructor throwing).
    """
    name0, size0 = platform.mesh_axes[0]
    parts = tuple(int(p) for p in parts)
    if not parts:
        raise ValueError("need at least one chunk")
    if any(p < 1 for p in parts):
        raise ValueError(f"every {name0}-axis chunk must be >= 1, "
                         f"got {parts}")
    if check_budget and sum(parts) > size0:
        raise ValueError(f"chunks {parts} overcommit mesh axis "
                         f"{name0}={size0}")
    import dataclasses
    return tuple(
        dataclasses.replace(
            platform,
            name=f"{platform.name}/{name0}[{i}]={p}",
            mesh_axes=((name0, p),) + platform.mesh_axes[1:])
        for i, p in enumerate(parts))


def enumerate_chip_splits(platform: Platform, n_nets: int
                          ) -> Tuple[Tuple[int, ...], ...]:
    """The default resource-partition decision axis for ``n_nets``
    networks sharing ``platform``: every ordered composition of mesh
    axis 0 into ``n_nets`` positive chunks (full allocation — the menu
    never overcommits, and under-provisioned platforms with fewer
    axis-0 slices than nets yield an EMPTY menu, i.e. an infeasible
    co-mapping). Deterministic lexicographic order: the joint-search
    history is defined over this order on every engine."""
    if n_nets < 1:
        raise ValueError(f"n_nets must be >= 1, got {n_nets}")
    _, size0 = platform.mesh_axes[0]
    out: List[Tuple[int, ...]] = []

    def rec(prefix: Tuple[int, ...], remaining: int, slots: int) -> None:
        if slots == 1:
            if remaining >= 1:
                out.append(prefix + (remaining,))
            return
        for p in range(1, remaining - slots + 2):
            rec(prefix + (p,), remaining - p, slots - 1)

    rec((), size0, n_nets)
    return tuple(out)


# Single-pod production platform (16 x 16 = 256 chips).
V5E_POD = Platform()

# Two-pod platform (2 x 16 x 16 = 512 chips); the "pod" axis carries pure
# data parallelism with hierarchically staged gradient reduction.
V5E_2POD = Platform(
    name="tpu-v5e-2x256",
    mesh_axes=(("pod", 2), ("data", 16), ("model", 16)),
)


@dataclass(frozen=True)
class AbstractPlatform(Platform):
    """Platform whose folds are unrestricted divisors (the paper's FPGA-style
    space, used for the Table-IV design-space-size benchmark). Realisability
    reduces to 'product of folds <= chips'."""

    def folds_realizable(self, folds: Sequence[int]) -> bool:  # type: ignore[override]
        prod = 1
        for f in folds:
            prod *= f
        return prod <= self.chips

    def fold_values(self) -> List[int]:  # type: ignore[override]
        return list(range(1, self.chips + 1))
