"""Peak device memory of ``chip_smoke.py``'s ``[lm]`` and ``[lm-dense]``
phases in a checkout, to compare two commits on one card.

    python3 tools/lm_peaks.py ROOT [inference]

Runs the device, build, ``[lm]`` and ``[lm-dense]`` phases of
``ROOT/chip_smoke.py`` with ``ROOT/src`` on the path (``ROOT`` a checkout,
for example another commit's ``git archive`` unpacked under ``build/``);
with ``inference`` both phases run under ``torch.inference_mode()``, as
``chip_smoke.py``'s ``main()`` runs them since the port trains. Prints one
line, ``PEAKS {...}``: each phase's (b) peak in bytes (weights included)
and the card's name and power limit. Needs a CUDA card.
"""
import contextlib
import json
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    wrap = sys.argv[2:] == ["inference"]
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    sys.argv = ["chip_smoke.py"]
    import chip_smoke as cs
    kind, smi = cs.phase_device()
    cs.phase_build()
    import torch
    ctx = torch.inference_mode if wrap else contextlib.nullcontext
    with ctx():
        _, _, lm = cs.phase_lm()
    torch.cuda.empty_cache()
    with ctx():
        _, _, dense = cs.phase_lm_dense()
    print("PEAKS", json.dumps({"root": str(root),
                               "lm_peak_bytes": lm["peak_bytes"],
                               "dense_peak_bytes": dense["peak_bytes"],
                               "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
