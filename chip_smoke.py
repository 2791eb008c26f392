#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero and no
phase's failure is caught while the run goes on:

  1. device   the card's name, power limit and CUDA version (no card: exit 1)
  2. build    the hand-written kernels, built from ``src/repro_torch/csrc``
              with nvcc for sm_90a; build seconds and ptxas's register /
              shared-memory report
  3. kernels  each kernel held against its plain PyTorch version on the card
              (segred: max bitwise, sum within 1e-6 relative in float32 and
              1e-12 in float64) at the main path's shape and a large one, in
              float32 and float64, with CUDA-event times beside the plain
              version's, one PyTorch library call's and the bound
  4. main     ``repro_torch.core.pipeline.optimise_mapping`` on tinyllama-1.1b
              / train_4k / V5E_POD with the rule-based optimiser and the torch
              engine, for two requests; each must equal the port's numpy
              engine (points, variables, history, objective) and the JAX
              package's recorded values, and must have launched the kernels

  5. profile (only with ``--profile``) the first request once more under
              ``torch.profiler``: device busy time, kernel count and the
              kernels that take the most device time, beside the wall time

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Longer records go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

#: the JAX package's results for these requests (CPU run of repro's
#: engine="jax" and engine="numpy", which agree): points, objective,
#: partitions, history length
REQUESTS = (
    {"exec_model": "streaming", "objective": "throughput",
     "points": 3288, "value": -0.4505275627007433, "partitions": 24,
     "history": 3},
    {"exec_model": "spmd", "objective": "latency",
     "points": 4031, "value": 0.22177328183717918, "partitions": 1,
     "history": 3},
)

SEGRED_SHAPES = ((28, 47), (65536, 47))     # main path's, and a large one


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; python {sys.version.split()[0]}; "
                  f"visible cards {torch.cuda.device_count()}")
    print(smi_line, flush=True)
    return kind, smi_line


def phase_build():
    from repro_torch.core.accel import cuda_build
    t0 = time.perf_counter()
    cuda_build.load("segred")
    info = cuda_build.BUILD_INFO["segred"]
    how = ("reused the library an earlier run built from the same source"
           if info["cached"] else f"nvcc {info['seconds']:.2f} s")
    say("build", f"segred: {how}, load total "
                 f"{time.perf_counter() - t0:.2f} s -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "ptxas" in line or "Used" in line:
            say("build", f"  {line.strip()}")
    return info


def _segred_inputs(N: int, n: int, dtype, seed: int):
    """Random positive node times and random monotone partition ids; row 0
    is one segment, row 1 has every node in its own segment, the rest cut
    with probabilities that vary by row, so most rows leave trailing
    segments empty (they must hold the identity)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    vals = rng.random((N, n)) + 1e-3
    prob = rng.random((N, 1))
    cuts = rng.random((N, n - 1)) < prob
    cuts[0] = False
    if N > 1:
        cuts[1] = True
    pid = np.concatenate([np.zeros((N, 1), np.int64),
                          np.cumsum(cuts, axis=1)], axis=1)
    return (torch.from_numpy(vals).to("cuda", dtype),
            torch.from_numpy(pid).to("cuda"))


def phase_kernels():
    import torch
    from repro_torch.core.accel import segred
    rows = []
    for N, n in SEGRED_SHAPES:
        for dtype in (torch.float32, torch.float64):
            vals, pid = _segred_inputs(N, n, dtype, seed=N + n)
            dname = str(dtype).replace("torch.", "")
            esize = vals.element_size()
            for op in ("max", "sum"):
                got = segred.segmented_reduce(vals, pid, op)
                want = segred.segmented_reduce_plain(vals, pid, op)
                torch.cuda.synchronize()
                if op == "max":
                    if not torch.equal(got, want):
                        fail(f"segred max {dname} [{N},{n}] not bitwise "
                             f"equal to the plain version")
                    rel = 0.0
                else:
                    rtol = 1e-6 if dtype == torch.float32 else 1e-12
                    diff = (got - want).abs()
                    rel = float(torch.where(want != 0, diff / want.abs(),
                                            diff).max())
                    if not bool((diff <= rtol * want.abs()).all()):
                        fail(f"segred sum {dname} [{N},{n}] off by {rel:.3g} "
                             f"relative (limit {rtol})")
                err = float((got - want).abs().nan_to_num(0.0).max())
                ident = -torch.inf if op == "max" else 0.0
                lib_op = "amax" if op == "max" else "sum"
                iters = 200 if N < 1000 else 50
                ms = cuda_ms(lambda: segred.segmented_reduce(vals, pid, op),
                             iters)
                plain_ms = cuda_ms(
                    lambda: segred.segmented_reduce_plain(vals, pid, op),
                    iters)
                library_ms = cuda_ms(
                    lambda: torch.full_like(vals, ident).scatter_reduce_(
                        1, pid, vals, lib_op, include_self=True), iters)
                # each input read once (vals + pid), the output written once
                nbytes = N * n * (esize + 8) + N * n * esize
                ops = N * n                  # one max/add per input element
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
                row = {"N": N, "n": n, "dtype": dname, "op": op,
                       "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations", "bytes": nbytes, "ops": ops}
                rows.append(row)
                say("kernels", f"segred {op} {dname} [{N},{n}]: ok, max abs "
                               f"err {err:.3g}; kernel {ms:.5f} ms, plain "
                               f"{plain_ms:.5f} ms, scatter_reduce "
                               f"{library_ms:.5f} ms, bound "
                               f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


def _history(points):
    return [(int(x), float(y)) for x, y in points]


def phase_main():
    import torch
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core import pipeline
    from repro_torch.core.accel import segred
    from repro_torch.core.platform import V5E_POD

    arch = get_arch("tinyllama-1.1b")
    shape = SHAPES_BY_NAME["train_4k"]
    # keep the optimiser's result inside optimise_mapping (the plan holds
    # folds per kind, not per node), so the one timed run is the one compared
    rule_based = pipeline.OPTIMIZERS["rule_based"]
    seen = []

    def keep(problem, **kw):
        seen.append(rule_based(problem, **kw))
        return seen[-1]

    launches = 0
    runs = []
    for req in REQUESTS:
        em, obj = req["exec_model"], req["objective"]
        tag = f"{em}/{obj}"
        ref = rule_based(pipeline.make_problem(arch, shape, V5E_POD, "spmd",
                                               obj, em), engine="numpy")
        seen.clear()
        pipeline.OPTIMIZERS["rule_based"] = keep
        try:
            segred.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = pipeline.optimise_mapping(
                arch, shape, V5E_POD, optimiser="rule_based", objective=obj,
                exec_model=em, engine="torch")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = segred.LAUNCHES
        finally:
            pipeline.OPTIMIZERS["rule_based"] = rule_based
        (got,) = seen
        points, history = got.points, _history(got.history)
        if n_launch <= 0:
            fail(f"{tag}: the main path launched the segred kernel 0 times")
        if (points, got.history, got.variables) != \
                (ref.points, ref.history, ref.variables):
            fail(f"{tag}: points/history/design {points}/{history} differ "
                 f"from the numpy engine's {ref.points}/"
                 f"{_history(ref.history)}")
        if plan.objective_value != ref.evaluation.objective:
            fail(f"{tag}: objective {plan.objective_value!r} != numpy "
                 f"engine's {ref.evaluation.objective!r}")
        if (points, plan.objective_value, len(plan.partitions),
                len(history)) != (req["points"], req["value"],
                                  req["partitions"], req["history"]):
            fail(f"{tag}: ({points}, {plan.objective_value!r}, "
                 f"{len(plan.partitions)}, {len(history)}) differs from the "
                 f"JAX package's ({req['points']}, {req['value']!r}, "
                 f"{req['partitions']}, {req['history']})")
        launches += n_launch
        runs.append({"request": tag, "points": points,
                     "objective": plan.objective_value,
                     "partitions": len(plan.partitions),
                     "history": history, "wall_s": wall,
                     "segred_launches": n_launch})
        say("main", f"{tag}: {points} points, objective "
                    f"{plan.objective_value!r}, {len(plan.partitions)} "
                    f"partitions, history {len(history)}; equal to numpy "
                    f"engine and JAX record; wall {wall:.3f} s; segred "
                    f"launches {n_launch}")
    return runs, launches


def phase_profile(runs):
    """The first request once more under torch.profiler. Device time is the
    sum of the traced kernel and copy durations (one stream, so they do not
    overlap); the idle share is one minus that over the unprofiled wall
    time of the same request in phase 4."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import V5E_POD

    req = REQUESTS[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimise_mapping(get_arch("tinyllama-1.1b"),
                         SHAPES_BY_NAME["train_4k"], V5E_POD,
                         optimiser="rule_based",
                         objective=req["objective"],
                         exec_model=req["exec_model"], engine="torch")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total, cnt + 1)
    device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
    plain_wall = runs[0]["wall_s"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"request": runs[0]["request"], "profiled_wall_s": wall,
           "wall_s": plain_wall, "device_s": device_s,
           "device_events": len(dev),
           "idle_share": (1.0 - device_s / plain_wall) if dev else None,
           "top": [{"name": k[:120], "device_s": v[0] * 1e-6, "count": v[1]}
                   for k, v in top]}
    if not dev:
        say("profile", "the profiler traced no device activity: device "
                       "time not measured")
        return out
    seg = [v for k, v in by_name.items() if "segred_kernel" in k]
    out["segred_device_s"] = sum(v[0] for v in seg) * 1e-6
    out["segred_events"] = sum(v[1] for v in seg)
    say("profile", f"{out['request']}: {len(dev)} device events, device busy "
                   f"{device_s:.4f} s of {plain_wall:.3f} s wall (idle share "
                   f"{out['idle_share']:.4f}); profiled wall {wall:.3f} s; "
                   f"segred kernel {out['segred_device_s']:.5f} s device "
                   f"time in {out['segred_events']} launches")
    for row in out["top"]:
        say("profile", f"  {row['device_s']:.5f} s  x{row['count']}  "
                       f"{row['name']}")
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    kind, smi_line = phase_device()
    import torch
    build = phase_build()
    rows = phase_kernels()
    runs, launches = phase_main()
    profiled = phase_profile(runs) if "--profile" in sys.argv[1:] else None

    main_row = next(r for r in rows if (r["N"], r["n"]) == SEGRED_SHAPES[0]
                    and r["dtype"] == "float32" and r["op"] == "max")
    kernels = [{
        "name": "segred", "route": "cuda",
        "source": "src/repro_torch/csrc/segred.cu",
        "replaces": "src/repro/core/accel/pallas_segred.py:31",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build": {"seconds": build["seconds"], "cached": build["cached"],
                  "ptxas": build["ptxas"]},
        "segred": rows, "main": runs, "profile": profiled,
        "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
