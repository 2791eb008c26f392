#!/usr/bin/env python3
"""Time segred's two kernels against the number of rows, on one CUDA card.

    python3 tools/segred_paths.py

``src/repro_torch/csrc/segred.cu`` launches one thread an output while
N n^2 <= ``kOutputCompares`` and the staged kernel past that. This builds
the committed source and two variants that take one path always (the
constant replaced), through the port's cached loader into
``build/segred_paths/``, beside the first design
(``tools/segred_first_design.cu``). At n = 47 (the mapper's graph) and rows
from 1 to 65,536, in float32 and float64, it holds each to the plain
version bitwise and reads its device time a launch under torch.profiler
(100 launches a trace, after a warm-up). Prints one line per case and
writes ``chiprun_out/segred_paths.json``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "segred.cu"
OUT = ROOT / "build" / "segred_paths"

_RULE = "constexpr int64_t kOutputCompares = 1 << 22;"
#: name -> the rule's replacement (None: the committed source)
VARIANTS = {"committed": None,
            "staged always": "constexpr int64_t kOutputCompares = 0;",
            "output always": "constexpr int64_t kOutputCompares = 1LL << 62;"}
ROWS = {"float32": (1, 28, 132, 528, 1056, 2112, 4224, 8448, 65536),
        "float64": (1, 28, 1056, 2112, 4224, 65536)}
NODES = 47


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke  # inputs, the first design's call, profiling
    from repro_torch.core.accel import cuda_build, segred
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = SOURCE.read_text()
    if _RULE not in base:
        raise SystemExit(f"{_RULE!r} is not in {SOURCE.name}")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, new in enumerate(VARIANTS.values()):
        cu = OUT / f"segred_path_{i}.cu"
        cu.write_text(base if new is None else base.replace(_RULE, new))
        sources[f"segred_path_{i}"] = cu
    sources["segred_first_design"] = chip_smoke.YARDSTICKS[
        "segred_first_design"]
    libs = cuda_build.load_all(list(sources), sources)
    rows = []
    for dname, cases in ROWS.items():
        dtype = getattr(torch, dname)
        entry = segred._ENTRY[dtype]
        fns = {name: chip_smoke._typed(libs[f"segred_path_{i}"], entry,
                                       segred._ARGTYPES)
               for i, name in enumerate(VARIANTS)}
        fns["first design"] = chip_smoke._typed(
            libs["segred_first_design"], entry, segred._ARGTYPES)
        for N in cases:
            vals, pid = chip_smoke._segred_inputs(N, NODES, dtype,
                                                  seed=N + NODES)
            for op in ("max", "sum"):
                want = segred.segmented_reduce_plain(vals, pid, op)
                times = {}
                for name, fn in fns.items():
                    def call():
                        return chip_smoke._segred_first(fn, vals, pid, op)
                    if not chip_smoke._bitwise_equal(call(), want):
                        raise SystemExit(f"{name} {dname} {op} [{N}, "
                                         f"{NODES}] differs from the plain "
                                         f"version")
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                    _, _, by_name = chip_smoke._profile(
                        lambda: [call() for _ in range(100)])
                    hits = [v for k, v in by_name.items()
                            if chip_smoke._is_segred(k)]
                    count = sum(v[1] for v in hits)
                    times[name] = (sum(v[0] for v in hits) / count
                                   if count else None)
                rows.append({"dtype": dname, "op": op, "N": N, "n": NODES,
                             "device_us": times})
                print(f"{dname} {op} [{N},{NODES}] device us a launch: "
                      + "; ".join(f"{k} {v:.3f}" if v is not None
                                  else f"{k} not measured"
                                  for k, v in times.items()), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "segred_paths.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
