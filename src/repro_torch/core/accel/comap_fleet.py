"""The co-mapping joint search on the card (the port of
``repro.core.accel.comap_fleet``).

The joint space of a ``CoMapProblem`` is S x N lanes — one per-net
sub-problem for every resource split in the menu. This module hands ALL
of them to the optimiser's fleet entry point in one call
(``core/accel/fleet.py``), which buckets the lanes by program shape, pads
each bucket bit-neutrally and runs the bucket as one lane-stacked device
pass: the nets of every split, each on its own sub-platform (platforms are
device data), are searched together, one brute-force chunk, SA sweep or
rule-based descent step of the whole bucket at a time, with one segred
launch a step, sweep or chunk with a cut whatever the lane count.

Because fleet results are bitwise those of the per-problem torch loop (the
``fleet.py`` contract) and the split/net combine is shared float64 host
arithmetic in ``core/comap.py``, the torch joint search returns the same
split, per-net designs, composite objective and history as the per-lane
loop; the coupled chip-budget constraint is applied to every candidate
split in that same combine, via ``CoMapProblem.budget_violations``.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.accel.fleet import (
    fleet_annealing,
    fleet_brute_force,
    fleet_rule_based,
)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["fleet_comap"]

_FLEETS = {
    "brute_force": fleet_brute_force,
    "annealing": fleet_annealing,
    "rule_based": fleet_rule_based,
}


def fleet_comap(lanes: Sequence, optimiser: str, **kw) -> List:
    """Run every (split, net) lane through one fleet invocation.

    ``lanes`` is the flat split-major list built by
    ``comap.joint_search``; the returned list preserves its order, so
    the host combine can slice lane blocks per split. Raises
    ``KeyError`` for optimisers without a fleet entry point — the
    caller's kwargs gate makes that unreachable in practice.
    """
    fleet = _FLEETS[optimiser]
    with _trace.span("comap.fleet", optimiser=optimiser,
                     lanes=len(lanes)):
        results = fleet(list(lanes), **kw)
    for r in results:
        _metrics.note_result(r, engine="fleet")
    return results
