#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s ``[fleet]`` (a) at several depths on one card.

    python3 tools/fleet_rb_depth.py 8 16 24

For each depth L, every arch of (a)'s portfolio keeps its full width and
at most L decoder and L encoder layers (``chip_smoke._fleet_arch``), and
(a) runs as ``chip_smoke.py`` runs it: ``optimise_portfolio`` timed, its
lockstep steps and segred launches, then the per-problem torch loop of
the same three lanes, each lane timed, each bitwise the fleet's lane. The
numpy references are not run. This is how (a)'s depth was chosen; each
line carries the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> None:
    depths = [int(a) for a in sys.argv[1:]] or [8]
    sys.path.insert(0, str(chip_smoke.SRC))
    _, smi_line = chip_smoke.phase_device()
    for layers in depths:
        chip_smoke.FLEET["rb"]["layers"] = layers
        with chip_smoke.phase_wall(f"fleet (a) at {layers} layers"):
            row = chip_smoke._fleet_rb(smi_line, [])
        chip_smoke.say("depth", f"{layers} layers: {row['steps']} steps, "
                                f"fleet {row['wall_s']:.3f} s, loop "
                                f"{row['loop_wall_s']:.3f} s "
                                f"{row['loop_lane_walls_s']}; {smi_line}")


if __name__ == "__main__":
    main()
