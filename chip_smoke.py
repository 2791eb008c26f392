#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line; any failure exits non-zero and no
phase's failure is caught while the run goes on:

  1. device   the card's name, power limit and CUDA version (no card: exit 1)
  2. build    the hand-written kernels, built from ``src/repro_torch/csrc``
              with nvcc for sm_90a, one nvcc per source, all started
              together (a later run reuses the libraries and says so);
              build seconds and ptxas's register / shared-memory / spill
              report (a spill store in the tensor-core flash kernel or the
              chunked WKV kernel fails). Built beside them, by the same
              cached loader from their own sources, as yardsticks timed in
              phase 3 and never used by the port: segred's first design
              (``tools/segred_first_design.cu``) and wkv6's step-by-step
              kernel (``tools/wkv6_step_design.cu``), run for bfloat16
  3. kernels  each kernel held against its plain PyTorch version on the card,
              with CUDA-event times (the kernel's, one PyTorch library
              call's where one exists and the earlier design's for segred
              and bf16 wkv6 as medians of rounds timed in turns) beside the
              plain version's and the bound:
              segred (max and sum bitwise, NaN where the plain version has
              it) at the mapper's shape, a brute-force chunk's and one node
              a row, in float32 and float64, with rows that are one segment,
              a segment a node, hold NaN and hold tied maxima; wkv6 (1e-4
              abs and rel with float32 r/k/v; with bfloat16 2e-2 abs and rel
              and, tighter, one bfloat16 rounding step; every output
              finite) at the JAX kernel test's shapes, a strong-decay case,
              decays with exact zeros and near 1e-30, T = 4097 and the LM
              phase's shape (2, 4096, 32, 64) in both types; flash_attn
              (2e-5 abs and rel in float32; in
              bfloat16 2e-2 abs and rel and, tighter, one bfloat16 rounding
              step) on the JAX kernel test's grid (shapes x dtype x causal),
              the reduced model's head size 32, two causal multi-tile cases
              (dh 128 and 32) and the dense LM phase's shape (B=2, S=4096,
              32 heads over 4 KV heads of 64, causal) in bfloat16 and
              float32, each timed beside scaled_dot_product_attention
  4. main     ``repro_torch.core.pipeline.optimise_mapping`` on tinyllama-1.1b
              / train_4k / V5E_POD with the rule-based optimiser and the torch
              engine, for two requests; each must equal the port's numpy
              engine (points, variables, history, objective) and the JAX
              package's recorded values, and must have launched segred
  5. search   the other two optimisers' entry points with the torch engine
              on the same arch, shape and platform (each timed call's plan
              equal to ``optimise_mapping``'s for the request): brute force
              (a) on the megatron backend, spmd/latency, every cut set of up
              to two cuts (201,933 points) and (b) on the spmd backend, the
              empty cut set's first 262,144 points in chunks of 65,536, each
              equal to the port's numpy engine run live and to the JAX
              package's record (points, design, history indices, objective;
              recorded objectives at 1e-5), segred launched in (a) and not in
              (b); (c) multi-chain SA (spmd backend, both of phase 4's
              requests, 64 chains, the default 342 sweeps): seed 0 twice
              identical, seed 1 another path, the whole schedule once more
              with every host sync an error and every chain's incumbent
              re-evaluated in float64 by the numpy engine (feasibility
              equal, objectives at 1e-5), and the schedule in float64
              with the same draws on the card and on the CPU, equal after
              every sweep (objectives within 1e-9); wall, points/s and
              segred launches of each request beside the card's name and
              power limit
  6. lm       ``repro_torch.models.model.Model(rwkv6-1.6b, use_flash=True)``
              at full width: (a) the first 2 layers with float32 weights from
              the seeded numpy recipe, B=1, T=128, held to the JAX package's
              record (loss 1e-4 relative, sampled logits 1e-3 absolute);
              (b) all 24 layers, bfloat16 weights drawn on the card from a
              seed, B=2, T=4096: wall per forward, tokens/s, WKV launches
              per forward (must be 24) and peak memory; every in-model WKV
              launch held to the plain version on the same inputs (2e-2 abs
              and rel, and one bfloat16 rounding step); the loss held to the
              same model with the plain WKV (1e-3 relative); the logits held
              to that model's within 1.5 times the distance between that
              model and the same model with the recurrence summed in
              float64 (random bfloat16 weights over 24 layers turn
              summation order alone into logit differences far above a
              fixed 6e-2, see PERF.md); (c) the (b) weights in float32, all
              24 layers: the kernel forward held to the plain-WKV float32
              forward (logits 1e-3 abs and rel, loss 1e-5 relative)
  7. lm-dense ``Model(tinyllama-1.1b, use_flash=True)`` at full width, the
              same two checks with flash attention in the kernel: (a) 2
              layers, float32 recipe weights, B=1, T=128, held to the JAX
              record ``DENSE_RECORD``; (b) all 22 layers in bfloat16 at B=2,
              T=4096: 22 kernel launches per forward, each held to the plain
              version (2e-2 and one bfloat16 rounding step), the loss held to the ``attn_impl="ref"`` model
              (1e-3 relative) and the logits within 1.5 times that model's
              distance from the same model with attention in float64

  8. profile (only with ``--profile``) the first mapping request, each
              [search] request (SA: spmd/latency) and one forward of each LM
              once more under ``torch.profiler``: device busy time, the idle
              share, the kernel's share and the kernels that take the most
              device time, beside the wall time; and
              segred's device time a launch beside its first design's, at
              the mapper's shape and a brute-force chunk's

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Longer records go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; FLOP/s for float32
#: and float64 outside the tensor cores, and bf16 dense on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}

#: the hand-written kernels, one source each under src/repro_torch/csrc
KERNELS = ("segred", "wkv6", "flash_attn")
#: kernels (by name) whose ptxas report must show no spill stores
NO_SPILL = ("flash_attn_mma_kernel", "wkv6_chunk_kernel")
#: the earlier designs, timed beside the kernels and never used by the port
YARDSTICKS = {"segred_first_design": ROOT / "tools" / "segred_first_design.cu",
              "wkv6_step_design": ROOT / "tools" / "wkv6_step_design.cu"}

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

#: [search] requests on tinyllama-1.1b / train_4k / V5E_POD. Brute force:
#: the settings and the JAX package's record (CPU run of repro's
#: engine="jax", equal to its engine="numpy"): points, objective, history
#: [(index, objective)] and design (cuts, s_in, s_out, kern). (a) takes
#: every cut set of up to two cuts (K1 in each of the 276 with a cut, at
#: [1024, 47]); (b) the empty cut set only, in chunks of 65,536 rows, which
#: is evaluated as one partition and launches K1 no time
SEARCH_BF = (
    {"name": "a", "backend": "megatron", "exec_model": "spmd",
     "objective": "latency", "kw": {"include_cuts": True, "max_cuts": 2},
     "points": 201933, "value": 0.22177328183717918,
     "history": [(55, 0.22177329659461975)],
     "variables": ((), [1] * 47, [1] * 47, [256] * 47), "segred": True},
    {"name": "b", "backend": "spmd", "exec_model": "spmd",
     "objective": "latency",
     "kw": {"include_cuts": False, "max_points": 262144,
            "batch_size": 65536},
     "points": 262144, "value": 4.319828488379967,
     "history": [(42312, 4.412864685058594), (42314, 4.32696533203125),
                 (48370, 4.319828510284424)],
     "variables": ((), [1, 1] + [16, 1] * 21 + [16] * 3,
                   [1, 1] + [16, 1] * 21 + [16] * 3,
                   [1, 256] * 22 + [1] * 3),
     "segred": False},
)
#: [search] (c): multi-chain SA on the spmd backend, for both of phase 4's
#: requests, 64 chains on the default schedule (342 sweeps), seeds 0 and 1
SEARCH_SA = {"backend": "spmd", "chains": 64, "sweeps": 342, "seeds": (0, 1)}
#: float32 agreement of recorded objectives with the float64 reference
F32_RTOL = 1e-5

#: the main path's shape, a brute-force chunk's, one node a row, and the
#: shapes of [search]: a brute-force chunk of (a) and the SA chains of (c)
SEGRED_SHAPES = ((28, 47), (65536, 47), (64, 1), (1024, 47), (64, 47))

#: wkv6 check shapes (B, T, H, hs) and decay ranges: tests/test_kernels.py's
#: WKV shapes, a strong-decay case, decays with exact zeros and near 1e-30,
#: a ragged T, the model's own decay (a long memory), and the [lm] phase's
#: shape
WKV_CHECKS = (
    ((1, 128, 2, 32), (0.55, 0.95)), ((2, 256, 4, 64), (0.55, 0.95)),
    ((1, 100, 2, 64), (0.55, 0.95)), ((1, 64, 1, 128), (0.55, 0.95)),
    ((1, 256, 2, 64), (0.02, 0.1)), ((1, 256, 2, 64), "zeros"),
    ((1, 256, 2, 64), "tiny"), ((1, 4097, 2, 64), (0.55, 0.95)),
    ((1, 4096, 8, 64), "model"),
)
WKV_LM_SHAPE = (2, 4096, 32, 64)
WKV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: in bfloat16 the kernel and its plain version both sum in float32 and
#: round once to bfloat16, so an output may differ from the plain one by
#: one rounding step (BF16_STEP of |want|) plus the float32 sums' order.
#: On the CPU each order lies within 2.6e-7 max|y| of the same recurrence
#: in float64 (T up to 2048, w up to 0.95, strong decay too), so the two
#: lie within about 5e-7 max|y| of each other; the slack
#: WKV_BF16_SLACK max|want| is four times that
WKV_BF16_SLACK = 2e-6
#: one bfloat16 rounding step, relative: 8 significant bits
BF16_STEP = 2.0 ** -7

#: the JAX package's loss and sampled logits [b, t, v, logit] for the port's
#: seeded numpy recipe (repro_torch.models.convert, seed 0): rwkv6-1.6b at
#: full width, layer_range (0, 2), float32, B=1, T=128; made on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
#:       rwkv6-1.6b 2 1 128 0
LM_RECORD = {
    "arch": "rwkv6-1.6b", "layers": 2, "batch": 1, "seq": 128, "seed": 0,
    "loss": 11.68708324432373,
    "logits": [
        [0, 0, 0, 0.28645339608192444], [0, 0, 1, -0.7389975786209106],
        [0, 0, 32767, -0.03645841404795647],
        [0, 0, 65535, -2.2897133827209473],
        [0, 1, 0, -0.2396697849035263], [0, 1, 1, -0.4577353000640869],
        [0, 1, 32767, -0.07143926620483398],
        [0, 1, 65535, -1.275397539138794],
        [0, 64, 0, 0.10178482532501221], [0, 64, 1, 0.7287406325340271],
        [0, 64, 32767, -2.187739372253418],
        [0, 64, 65535, 1.1632769107818604],
        [0, 127, 0, 0.9406948089599609], [0, 127, 1, 1.22970712184906],
        [0, 127, 32767, 0.11191505193710327],
        [0, 127, 65535, 0.2801424264907837],
    ],
}
LM_FULL = {"arch": "rwkv6-1.6b", "batch": 2, "seq": 4096, "seed": 1,
           "runs": 3}
#: [lm] (b): the kernel forward's logits may lie at most this many times as
#: far from the plain-WKV forward's as the plain forward's lie from the same
#: model with its recurrence summed in float64
LOGIT_YARDSTICK = 1.5
#: [lm] (c): the (b) weights in float32, the kernel forward against the
#: plain-WKV forward: logits within this abs and rel, loss within
#: LM_F32_LOSS_TOL relative. Only the WKV sums' order differs, about 1e-7
#: of an output, which 24 layers amplify to about 4e-4 in the logits on an
#: H100 (PERF.md)
LM_F32_LOGIT_TOL = 1e-3
LM_F32_LOSS_TOL = 1e-5

#: flash_attn check shapes (B, Sq, Skv, H, Hkv, dh): tests/test_kernels.py's
#: FLASH_SHAPES, the reduced model's head size, and [lm-dense] (b)'s shape
FLASH_SHAPES = ((1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
                (1, 64, 64, 4, 1, 128), (2, 37, 37, 4, 2, 64),
                (1, 16, 512, 2, 2, 64), (2, 100, 100, 4, 2, 32))
FLASH_LM_SHAPE = (2, 4096, 4096, 32, 4, 64)
#: causal multi-tile cases the small grid cannot reach: many 64-key tiles
#: at dh = 128 (group 8) and at dh = 32 (no grouping)
FLASH_DEEP_SHAPES = ((1, 2048, 2048, 16, 2, 128), (1, 1024, 1024, 8, 8, 32))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: in bfloat16 the plain version works in float32 and rounds once to
#: bfloat16, and the kernel carries P as bf16 hi + lo (about 2**-16 of p),
#: so an output may differ from the plain one by one rounding step
#: (BF16_STEP of |want|) plus the float32 sums' order (under
#: FLASH_BF16_SLACK of the largest |v|). At S = 4096 the outputs are
#: averages of thousands of values, so 2e-2 abs is as large as a typical
#: output and could not see a dropped KV tile; this limit can
FLASH_BF16_SLACK = 2e-5

#: as LM_RECORD, for tinyllama-1.1b (full width, layers 0-2, float32 recipe
#: weights, B=1, T=128, seed 0); made on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
#:       tinyllama-1.1b 2 1 128 0
DENSE_RECORD = {
    "arch": "tinyllama-1.1b", "layers": 2, "batch": 1, "seq": 128, "seed": 0,
    "loss": 10.815146446228027,
    "logits": [
        [0, 0, 0, 0.6712658405303955], [0, 0, 1, 1.1410504579544067],
        [0, 0, 15999, -1.7576838731765747], [0, 0, 31999, 1.4409105777740479],
        [0, 1, 0, -0.3859884440898895], [0, 1, 1, 1.9796931743621826],
        [0, 1, 15999, -0.3091917335987091], [0, 1, 31999, 0.5858257412910461],
        [0, 64, 0, -0.5660134553909302], [0, 64, 1, 2.839251756668091],
        [0, 64, 15999, 0.8963364958763123],
        [0, 64, 31999, -1.3923943042755127],
        [0, 127, 0, 0.9991924166679382], [0, 127, 1, 1.6598496437072754],
        [0, 127, 15999, -0.5693889260292053],
        [0, 127, 31999, 0.41556504368782043],
    ],
}
DENSE_FULL = {"arch": "tinyllama-1.1b", "batch": 2, "seq": 4096, "seed": 1,
              "runs": 3}


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


def cuda_ms_turns(fns, iters, rounds=5, warmup=5):
    """The median over ``rounds`` of ``cuda_ms`` for each of ``fns``, timed
    in turns (fn 0, fn 1, ..., then again), so that a slow stretch of the
    shared host, which sets the time of a call this small, falls on all of
    them alike."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            times[i].append(cuda_ms(fn, iters, warmup=warmup))
    return [sorted(t)[len(t) // 2] for t in times]


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


def _typed(lib, entry, argtypes):
    """``lib``'s C entry point ``entry``, typed."""
    import ctypes
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _wkv_step(fn, r, k, v, w, u):
    """One launch of the step-by-step yardstick's typed entry point."""
    import torch
    B, T, H, hs = r.shape
    out = torch.empty_like(r)
    if fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
          u.data_ptr(), out.data_ptr(), B, T, H, hs,
          torch.cuda.current_stream().cuda_stream):
        fail("the step-by-step wkv6 yardstick did not launch")
    return out


def phase_build():
    from repro_torch.core.accel import cuda_build, segred
    from repro_torch.kernels import rwkv6_scan
    t0 = time.perf_counter()
    libs = cuda_build.load_all(KERNELS + tuple(YARDSTICKS), YARDSTICKS)
    wall = time.perf_counter() - t0
    yardsticks = {
        "segred": {str(dt).replace("torch.", ""): _typed(
            libs["segred_first_design"], entry, segred._ARGTYPES)
            for dt, entry in segred._ENTRY.items()},
        "wkv6": _typed(libs["wkv6_step_design"], "wkv6_bf16",
                       rwkv6_scan._ARGTYPES)}
    for name in KERNELS + tuple(YARDSTICKS):
        info = cuda_build.BUILD_INFO[name]
        how = ("reused the library an earlier run built from the same source"
               if info["cached"] else f"nvcc {info['seconds']:.2f} s")
        say("build", f"{name}: {how} -> {info['path']}")
        function = ""
        for line in info["ptxas"].splitlines():
            if "Function properties for" in line:
                function = line.rsplit(" ", 1)[-1]
            if "ptxas" in line or "Used" in line or "spill" in line:
                say("build", f"  {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores", line)
            # the tensor-core kernels keep their fragments in registers
            if spill and int(spill.group(1)) and name in KERNELS and \
                    any(k in function for k in NO_SPILL):
                fail(f"ptxas spills {spill.group(1)} bytes in {function}")
    say("build", f"all kernels and the two yardsticks loaded in {wall:.2f} s "
                 f"(builds in parallel)")
    return ({name: dict(cuda_build.BUILD_INFO[name]) for name in KERNELS},
            yardsticks)


def _segred_inputs(N: int, n: int, dtype, seed: int):
    """Random positive node times and random monotone partition ids; row 0
    is one segment, row 1 has every node in its own segment, row 4 holds a
    NaN and row 5 tied maxima (where the rows and nodes exist), the rest
    cut with probabilities that vary by row, so most rows leave trailing
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
    if N > 5 and n > 2:
        vals[4, n // 2] = np.nan
        vals[5] = np.round(vals[5] * 4) / 4      # few distinct values: ties
    pid = np.concatenate([np.zeros((N, 1), np.int64),
                          np.cumsum(cuts, axis=1)], axis=1)
    return (torch.from_numpy(vals).to("cuda", dtype),
            torch.from_numpy(pid).to("cuda"))


def _bitwise_equal(got, want):
    """The same NaN positions, and every other element bit for bit."""
    import torch
    nan = torch.isnan(want)
    ints = torch.int32 if got.dtype == torch.float32 else torch.int64
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(ints)[~nan], want.view(ints)[~nan])


def _segred_first(fn, vals, pid, op):
    """One call of segred's first design (typed entry ``fn``) with the
    wrapper's host work, so that the two designs' calls differ only in
    their kernels."""
    import torch
    from repro_torch.core.accel import segred
    segred._check(vals, pid, op)
    out = torch.empty_like(vals)
    N, n = vals.shape
    if fn(vals.data_ptr(), pid.data_ptr(), out.data_ptr(), N, n,
          segred.OPS[op], torch.cuda.current_stream().cuda_stream):
        fail("segred's first design did not launch")
    return out


def phase_kernels(yardsticks):
    import torch
    from repro_torch.core.accel import segred
    rows = []
    for N, n in SEGRED_SHAPES:
        for dtype in (torch.float32, torch.float64):
            vals, pid = _segred_inputs(N, n, dtype, seed=N + n)
            dname = str(dtype).replace("torch.", "")
            esize = vals.element_size()
            first = yardsticks["segred"][dname]

            for op in ("max", "sum"):
                got = segred.segmented_reduce(vals, pid, op)
                want = segred.segmented_reduce_plain(vals, pid, op)
                torch.cuda.synchronize()
                if not _bitwise_equal(got, want):
                    fail(f"segred {op} {dname} [{N},{n}] not bitwise equal "
                         f"to the plain version")
                err = float((got - want).abs().nan_to_num(0.0).max())
                ident = -torch.inf if op == "max" else 0.0
                lib_op = "amax" if op == "max" else "sum"
                iters = 200 if N < 1000 else 50
                # the kernel, its first design and the library call in
                # turns on the same inputs
                ms, old_ms, library_ms = cuda_ms_turns([
                    lambda: segred.segmented_reduce(vals, pid, op),
                    lambda: _segred_first(first, vals, pid, op),
                    lambda: torch.full_like(vals, ident).scatter_reduce_(
                        1, pid, vals, lib_op, include_self=True)], iters)
                plain_ms = cuda_ms(
                    lambda: segred.segmented_reduce_plain(vals, pid, op),
                    iters)
                # each input read once (vals + pid), the output written once
                nbytes = N * n * (esize + 8) + N * n * esize
                ops = N * n                  # one max/add per input element
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
                row = {"N": N, "n": n, "dtype": dname, "op": op,
                       "max_abs_err": err, "ms": ms,
                       "first_design_ms": old_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations", "bytes": nbytes, "ops": ops}
                rows.append(row)
                say("kernels", f"segred {op} {dname} [{N},{n}]: ok, bitwise "
                               f"equal; kernel {ms:.5f} ms, first design "
                               f"{old_ms:.5f} ms (medians in turns), plain "
                               f"{plain_ms:.5f} ms, scatter_reduce "
                               f"{library_ms:.5f} ms, bound "
                               f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


def _wkv_inputs(shape, w_range, dtype, seed):
    """(B, T, H, hs) r, k, v ~ N(0, 0.25) in ``dtype``, float32 w uniform
    in ``w_range`` and u ~ N(0, 0.01) of shape (H, hs), drawn on the card
    from ``seed``. ``w_range`` "zeros" or "tiny" puts a third of the
    multipliers at exactly 0 or near 1e-30, the rest in [0.55, 0.95];
    "model" draws the model's own decay, exp(-exp(-4 + 0.01 x)), about
    0.98 (models/rwkv.py)."""
    import torch
    B, T, H, hs = shape
    g = torch.Generator("cuda").manual_seed(seed)

    def normal(*size):
        return torch.randn(size, generator=g, device="cuda")

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B, T, H, hs), generator=g,
                                           device="cuda")

    r, k, v = (0.5 * normal(B, T, H, hs) for _ in range(3))
    if w_range == "model":
        w = torch.exp(-torch.exp(-4.0 + 0.01 * normal(B, T, H, hs)))
    elif isinstance(w_range, str):
        edge = {"zeros": 0.0, "tiny": 1e-30}[w_range]
        w = torch.where(uniform(0.0, 1.0) < 1 / 3, edge * uniform(1.0, 2.0),
                        uniform(0.55, 0.95))
    else:
        w = uniform(*w_range)
    u = 0.1 * normal(H, hs)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u


def _wkv_bound(shape, dtype):
    """The least time for the function on this card: each input read once
    and the output written once (r, k, v, out in their dtype, w and u in
    float32), and about 4*hs operations per (token, channel) — two
    multiply-adds of the readout and two of the state update — at the
    card's peak for the inputs' type: bfloat16 on the tensor cores (where
    the chunked kernel runs its products), float32 on the CUDA cores."""
    import torch
    B, T, H, hs = shape
    n = B * T * H * hs
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = n * (4 * esize + 4) + H * hs * 4
    ops = n * 4 * hs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _limit_used(got, want, tol, slack):
    """The largest share of its limit any output element uses (<= 1
    holds): ``tol`` abs and rel, and in bfloat16 also one rounding step,
    BF16_STEP of |want| plus the absolute ``slack``."""
    import torch
    gf, wf = got.float(), want.float()
    diff, mag = (gf - wf).abs(), wf.abs()
    used = float((diff / (tol * (1 + mag))).max())
    if got.dtype == torch.bfloat16:
        used = max(used, float((diff / (BF16_STEP * mag + max(slack, 1e-30)))
                               .max()))
    return used


def _wkv_limit_used(got, want):
    """``_limit_used`` at WKV_TOL and, in bfloat16, WKV_BF16_SLACK of max
    |want|."""
    dname = str(got.dtype).replace("torch.", "")
    return _limit_used(got, want, WKV_TOL[dname],
                       WKV_BF16_SLACK * float(want.float().abs().max()))


def phase_wkv6(yardsticks):
    import torch
    from repro_torch.kernels import rwkv6_scan
    step = yardsticks["wkv6"]
    checks = [(shape, w, dtype) for shape, w in WKV_CHECKS
              for dtype in (torch.float32, torch.bfloat16)]
    checks += [(WKV_LM_SHAPE, (0.55, 0.95), torch.bfloat16),
               (WKV_LM_SHAPE, (0.55, 0.95), torch.float32)]
    rows = []
    for i, (shape, w_range, dtype) in enumerate(checks):
        args = _wkv_inputs(shape, w_range, dtype, seed=100 + i)
        got = rwkv6_scan.wkv6(*args)
        want = rwkv6_scan.wkv6_plain(*args)
        torch.cuda.synchronize()
        dname = str(dtype).replace("torch.", "")
        tol = WKV_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        used = _wkv_limit_used(got, want)
        if got.dtype != dtype or not bool(torch.isfinite(got).all()) or \
                not used <= 1.0:
            fail(f"wkv6 {dname} {shape} w in {w_range}: max abs err {err:.3g}"
                 f", {used:.3g} of the limit ({tol} abs and rel"
                 f"{'' if dname == 'float32' else '; one rounding step'}) "
                 f"of the plain version")
        big = shape[1] >= 1024
        iters = 20 if big else 200
        old_ms = None
        if dtype == torch.bfloat16:
            # and the step kernel this one replaced, in turns on the same
            # inputs
            ms, old_ms = cuda_ms_turns(
                [lambda: rwkv6_scan.wkv6(*args),
                 lambda: _wkv_step(step, *args)], iters, rounds=3)
        else:
            ms, = cuda_ms_turns([lambda: rwkv6_scan.wkv6(*args)], iters,
                                rounds=3)
        plain_ms = cuda_ms(lambda: rwkv6_scan.wkv6_plain(*args),
                           2 if big else 5, warmup=1)
        row = {"shape": list(shape),
               "w_range": w_range if isinstance(w_range, str)
               else list(w_range),
               "dtype": dname, "max_abs_err": err, "limit_used": used,
               "ms": ms, "step_kernel_ms": old_ms,
               "plain_ms": plain_ms, "library_ms": None,
               **_wkv_bound(shape, dtype)}
        rows.append(row)
        old = "" if old_ms is None else \
            f", step kernel {old_ms:.5f} ms (medians in turns)"
        say("kernels", f"wkv6 {dname} (B,T,H,hs)={shape} w {w_range}: ok, "
                       f"max abs err {err:.3g} ({used:.3g} of the limit); "
                       f"kernel {ms:.5f} ms{old}, plain {plain_ms:.3f} ms, "
                       f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
                       f"no single library call")
    return rows


def _flash_inputs(shape, dtype, seed):
    """q (B, Sq, H, dh) and k, v (B, Skv, Hkv, dh), standard normal in
    ``dtype``, drawn on the card from ``seed``."""
    import torch
    B, Sq, Skv, H, Hkv, dh = shape
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                           (B, Skv, Hkv, dh)))


def _flash_bound(shape, dtype, causal):
    """The least time for the function on this card: q, k, v read once and
    the output written once; 4*dh operations (two multiply-adds of q.k and
    of p.v per head dimension) for each (query, key) pair the mask lets
    through, at the input type's peak rate (bf16 on the tensor cores).
    ``cuda_core_ms`` is the same operations at the float32 rate of the CUDA
    cores, the floor of the float32 kernel, which computes there."""
    import torch
    B, Sq, Skv, H, Hkv, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * dh * (2 * Sq * H + 2 * Skv * Hkv)
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    ops = 4 * dh * pairs * B * H
    dname = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "cuda_core_ms": ops / PEAK_OPS_PER_S["float32"] * 1e3,
            "bytes": nbytes, "ops": ops}


def _flash_limit_used(got, want, v):
    """``_limit_used`` at FLASH_TOL and, in bfloat16, FLASH_BF16_SLACK of
    max |v|."""
    dname = str(got.dtype).replace("torch.", "")
    return _limit_used(got, want, FLASH_TOL[dname],
                       FLASH_BF16_SLACK * float(v.float().abs().max()))


def phase_flash():
    """flash_attn against its plain version (``ref.attention``) on the JAX
    kernel test's grid and the dense LM's shape; CUDA-event times of the
    kernel, the plain version and ``scaled_dot_product_attention`` (one
    PyTorch call of the same function, timed here only: the port never
    calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    checks = [(shape, dtype, causal) for shape in FLASH_SHAPES
              for dtype in (torch.float32, torch.bfloat16)
              for causal in (True, False)
              if not (causal and shape[1] != shape[2])]
    checks += [(shape, dtype, True) for shape in FLASH_DEEP_SHAPES
               for dtype in (torch.float32, torch.bfloat16)]
    checks += [(FLASH_LM_SHAPE, torch.bfloat16, True),
               (FLASH_LM_SHAPE, torch.float32, True)]
    rows = []
    for i, (shape, dtype, causal) in enumerate(checks):
        q, k, v = _flash_inputs(shape, dtype, seed=200 + i)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        dname = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        used = _flash_limit_used(got, want, v)
        if got.dtype != dtype or not bool(torch.isfinite(got).all()) or \
                not used <= 1.0:
            fail(f"flash_attn {dname} {shape} causal={causal}: max abs err "
                 f"{err:.3g}, {used:.3g} of the limit ({tol} abs and rel"
                 f"{'' if dname == 'float32' else '; one rounding step'}) "
                 f"of the plain version")
        del got, want
        big = shape[1] >= 1024
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # the kernel and the library call in turns on the same inputs
        ms, library_ms = cuda_ms_turns([
            lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)],
            10 if big else 100, rounds=3, warmup=2 if big else 5)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            3 if big else 50, warmup=1 if big else 5)
        row = {"shape": list(shape), "dtype": dname, "causal": causal,
               "max_abs_err": err, "limit_used": used, "ms": ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms,
               **_flash_bound(shape, dtype, causal)}
        rows.append(row)
        say("kernels", f"flash_attn {dname} (B,Sq,Skv,H,Hkv,dh)={shape} "
                       f"causal={causal}: ok, max abs err {err:.3g} ({used:.3g} "
                       f"of the limit); kernel "
                       f"{ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
                       f"{library_ms:.5f} ms, bound {row['bound_ms']:.5f} ms "
                       f"({row['bound_by']}; float32 CUDA cores "
                       f"{row['cuda_core_ms']:.5f} ms)")
        torch.cuda.empty_cache()
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


def _timed_search(problem, optimiser, **kw):
    """One call of the optimiser's entry point with the torch engine on
    the card: (plan, result, wall seconds, segred launches). The launch
    count is set to 0 just before the call and read just after it; the
    wall time ends in ``torch.cuda.synchronize()``. The plan is
    ``export_plan`` of the result, as ``optimise_mapping`` makes it."""
    import torch
    from repro_torch.core.accel import segred
    from repro_torch.core.exporter import export_plan
    from repro_torch.core.optimizers import OPTIMIZERS
    torch.cuda.synchronize()
    segred.LAUNCHES = 0
    t0 = time.perf_counter()
    result = OPTIMIZERS[optimiser](problem, engine="torch", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segred.LAUNCHES
    plan = export_plan(problem.graph, result.variables, problem.platform,
                       problem.exec_model, result.evaluation)
    return plan, result, wall, launches


def _check_entry_point(tag, plan, optimiser, req_kw, **kw):
    """``optimise_mapping`` with the torch engine on the card must return
    the plan of the optimiser's own call."""
    from repro_torch.core import pipeline
    got = pipeline.optimise_mapping(optimiser=optimiser, engine="torch",
                                    **kw, **req_kw)
    if got != plan:
        fail(f"[search] {tag}: optimise_mapping's plan (objective "
             f"{got.objective_value!r}) differs from the optimiser's "
             f"({plan.objective_value!r})")


def _design(v):
    return (tuple(v.cuts), list(v.s_in), list(v.s_out), list(v.kern))


def _same_history(got, want):
    """History indices equal, objectives at the float32 contract."""
    return [i for i, _ in got] == [i for i, _ in want] and all(
        abs(a - b) <= F32_RTOL * abs(b) for (_, a), (_, b) in zip(got, want))


def _search_bf(req, arch, shape, smi_line):
    from repro_torch.core import pipeline
    from repro_torch.core.platform import V5E_POD
    tag = (f"({req['name']}) brute force {req['backend']} "
           f"{req['exec_model']}/{req['objective']}")
    problem = pipeline.make_problem(arch, shape, V5E_POD, req["backend"],
                                    req["objective"], req["exec_model"])
    t0 = time.perf_counter()
    ref = pipeline.OPTIMIZERS["brute_force"](problem, engine="numpy",
                                             **req["kw"])
    numpy_wall = time.perf_counter() - t0
    plan, got, wall, n_launch = _timed_search(problem, "brute_force",
                                              **req["kw"])
    _check_entry_point(tag, plan, "brute_force", req["kw"], arch=arch,
                       shape=shape, platform=V5E_POD, backend=req["backend"],
                       objective=req["objective"],
                       exec_model=req["exec_model"])
    if (got.points, _design(got.variables)) != \
            (ref.points, _design(ref.variables)) or \
            not _same_history(got.history, ref.history) or \
            plan.objective_value != ref.evaluation.objective:
        fail(f"[search] {tag}: {got.points} points, history "
             f"{_history(got.history)}, objective {plan.objective_value!r} "
             f"differ from the numpy engine's {ref.points}, "
             f"{_history(ref.history)}, {ref.evaluation.objective!r}")
    if (got.points, plan.objective_value, _design(got.variables)) != \
            (req["points"], req["value"], req["variables"]) or \
            not _same_history(got.history, req["history"]):
        fail(f"[search] {tag}: ({got.points}, {plan.objective_value!r}, "
             f"{_history(got.history)}) differs from the JAX record "
             f"({req['points']}, {req['value']!r}, {req['history']})")
    if req["segred"] and n_launch <= 0:
        fail(f"[search] {tag}: the cut sets with a cut launched segred 0 "
             f"times")
    if not req["segred"] and n_launch:
        fail(f"[search] {tag}: the single-partition path launched segred "
             f"{n_launch} times")
    row = {"request": tag, "points": got.points,
           "objective": plan.objective_value,
           "history": _history(got.history), "wall_s": wall,
           "points_per_s": got.points / wall, "segred_launches": n_launch,
           "numpy_wall_s": numpy_wall,
           "numpy_points_per_s": ref.points / numpy_wall, "device": smi_line}
    say("search", f"{tag}: {got.points} points, objective "
                  f"{plan.objective_value!r}, history {len(got.history)}; "
                  f"equal to the numpy engine and the JAX record; wall "
                  f"{wall:.3f} s, {row['points_per_s']:.0f} points/s (numpy "
                  f"engine {numpy_wall:.3f} s, "
                  f"{row['numpy_points_per_s']:.0f} points/s); segred "
                  f"launches {n_launch}"
                  + ("" if n_launch else " (one partition: no segmented "
                                         "reduction)") + f"; {smi_line}")
    return row


def _sa_start(problem, dev, dtype):
    """A DeviceSA on ``dev`` in ``dtype``, the repaired start design and
    its evaluation, the objective scale and the ladder, as
    ``annealing._optimise_torch`` makes them."""
    import torch
    from repro_torch.core.accel.search_loops import DeviceSA
    from repro_torch.core.optimizers.annealing import LADDER_SPREAD, _scale_for
    from repro_torch.core.optimizers.common import repair
    sa = DeviceSA(problem, device=dev, dtype=dtype)
    v0 = repair(problem, problem.backend.initial(problem.graph))
    ev0 = problem.evaluate(v0)
    temps = torch.tensor([1000.0 * LADDER_SPREAD ** c
                          for c in range(SEARCH_SA["chains"])],
                         dtype=dtype, device=dev)
    return sa, v0, ev0, _scale_for(ev0, None), temps


def _sa_float64_card_vs_cpu(problem, tag):
    """The same float64 draws (from a CPU generator) on the card and on
    the CPU, sweep by sweep over the whole schedule: the chains' folds,
    cuts and feasibility equal after every sweep, their objectives within
    1e-9; each incumbent equal, or tied with the other device's in the
    float64 re-evaluation (a tie that the last bit of a sum can break
    either way). Returns the number of such ties."""
    import numpy as np
    import torch
    from repro_torch.core.accel.search_loops import SweepDraws, sa_draws
    C, n = SEARCH_SA["chains"], len(problem.graph.nodes)
    runs = {}
    for dev in ("cuda", "cpu"):
        sa, v0, ev0, scale, temps = _sa_start(problem, dev, torch.float64)
        runs[dev] = [sa, sa.init_state(v0, ev0, C, 0), temps]
    gen = torch.Generator().manual_seed(7)
    bev = problem.batched()
    names = ("best_si", "best_so", "best_kk", "best_cb")
    ties = 0
    for k in range(SEARCH_SA["sweeps"]):
        dr = sa_draws(gen, C, n, torch.float64)
        st = {}
        for dev, run in runs.items():
            sa, state, temps = run
            state, temps, _ = sa.run(state, temps, scale, 0.98, 1.0, 1,
                                     draws=[SweepDraws(*(x.to(dev)
                                                         for x in dr))])
            run[1], run[2] = state, temps
            st[dev] = {key: v.cpu().numpy() for key, v in state.items()
                       if key != "gen"}
        a, b = st["cuda"], st["cpu"]
        for name in ("si", "so", "kk", "cb", "feas", "best_feas"):
            if not np.array_equal(a[name], b[name]):
                fail(f"[search] {tag}: float64 {name} on the card differs "
                     f"from the CPU's after sweep {k}")
        for name in ("obj", "best_obj"):
            if not np.allclose(a[name], b[name], rtol=1e-9, atol=0.0):
                fail(f"[search] {tag}: float64 {name} on the card differs "
                     f"from the CPU's by more than 1e-9 after sweep {k}")
        differ = np.zeros(C, bool)
        for name in names:
            differ |= (a[name] != b[name]).any(axis=1)
        rows = np.nonzero(differ)[0]
        if len(rows):
            ra = bev.evaluate_batch(*(a[x][rows] for x in names))
            rb = bev.evaluate_batch(*(b[x][rows] for x in names))
            if not (np.array_equal(ra.feasible, rb.feasible) and np.allclose(
                    ra.objective, rb.objective, rtol=1e-12, atol=0.0)):
                fail(f"[search] {tag}: float64 incumbents of chains "
                     f"{rows.tolist()} differ between card and CPU after "
                     f"sweep {k}, and not by a tie")
            ties += len(rows)
    return ties


def _search_sa(em, obj, arch, shape, smi_line):
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.core.optimizers.common import incumbent_better
    from repro_torch.core.platform import V5E_POD
    tag = f"(c) annealing {SEARCH_SA['backend']} {em}/{obj}"
    problem = pipeline.make_problem(arch, shape, V5E_POD,
                                    SEARCH_SA["backend"], obj, em)
    seed, other = SEARCH_SA["seeds"]
    kw = dict(chains=SEARCH_SA["chains"])
    plan, r1, wall, n_launch = _timed_search(problem, "annealing", seed=seed,
                                             **kw)
    _check_entry_point(tag, plan, "annealing", dict(kw, seed=seed),
                       arch=arch, shape=shape, platform=V5E_POD,
                       backend=SEARCH_SA["backend"], objective=obj,
                       exec_model=em)
    _, r2, _, _ = _timed_search(problem, "annealing", seed=seed, **kw)
    _, r3, _, _ = _timed_search(problem, "annealing", seed=other, **kw)
    points = SEARCH_SA["chains"] * SEARCH_SA["sweeps"]
    if r1.points != points:
        fail(f"[search] {tag}: {r1.points} points, not {points}")
    if (_design(r2.variables), r2.history, r2.points) != \
            (_design(r1.variables), r1.history, r1.points):
        fail(f"[search] {tag}: two runs with seed {seed} differ")
    if (_design(r3.variables), r3.history) == \
            (_design(r1.variables), r1.history):
        fail(f"[search] {tag}: seed {other} walked seed {seed}'s path")
    if n_launch <= 0:
        fail(f"[search] {tag}: the sweeps launched segred 0 times")
    ev = r1.evaluation                 # the float64 scalar reference's
    last = r1.history[-1][1]
    if ev.feasible and abs(last - ev.objective) > F32_RTOL * abs(ev.objective):
        fail(f"[search] {tag}: the incumbent's float32 objective {last!r} "
             f"is not the reference's {ev.objective!r}")

    # the same schedule straight through DeviceSA.run with every host sync
    # an error; its incumbent is the optimiser's
    sa, v0, ev0, scale, temps = _sa_start(problem, "cuda", torch.float32)
    state = sa.init_state(v0, ev0, SEARCH_SA["chains"], seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, temps, _ = sa.run(state, temps, scale, 0.98, 1.0,
                                 SEARCH_SA["sweeps"])
    except RuntimeError as err:
        fail(f"[search] {tag}: a sweep synchronised with the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    best = None
    for v, o, f in sa.best_variables(state):
        if best is None or incumbent_better(f, o, best[2], best[1]):
            best = (v, o, f)
    if _design(best[0]) != _design(r1.variables):
        fail(f"[search] {tag}: the sync-free run's incumbent differs from "
             f"the optimiser's")
    # every chain's incumbent, feasible or not, re-evaluated in float64 by
    # the numpy engine: feasibility equal, the card's float32 objective at
    # the float32 contract
    bev = problem.batched()
    chains = sa.best_variables(state)
    want = bev.evaluate_batch(*bev.pack([v for v, _, _ in chains]))
    objs = np.array([o for _, o, _ in chains])
    feas = np.array([f for _, _, f in chains])
    if not np.array_equal(feas, want.feasible):
        fail(f"[search] {tag}: the incumbents' feasibility on the card "
             f"differs from the numpy engine's in chains "
             f"{np.nonzero(feas != want.feasible)[0].tolist()}")
    rel = np.abs(objs - want.objective) / np.abs(want.objective)
    if not rel.max() <= F32_RTOL:
        fail(f"[search] {tag}: an incumbent's float32 objective is "
             f"{rel.max():.3g} from the numpy engine's float64 value "
             f"(chain {int(rel.argmax())}, limit {F32_RTOL})")
    ties = _sa_float64_card_vs_cpu(problem, tag)
    row = {"request": tag, "points": r1.points,
           "objective": plan.objective_value, "feasible": ev.feasible,
           "history": _history(r1.history), "wall_s": wall,
           "points_per_s": r1.points / wall, "segred_launches": n_launch,
           "float64_incumbent_ties": ties, "device": smi_line}
    say("search", f"{tag}: {r1.points} points, objective "
                  f"{plan.objective_value!r} (feasible {ev.feasible}), "
                  f"history {len(r1.history)}; seed {seed} twice identical, "
                  f"seed {other} another path; no host sync in "
                  f"{SEARCH_SA['sweeps']} sweeps; {len(chains)} incumbents "
                  f"equal to the numpy engine's float64 re-evaluation; "
                  f"float64 card equal to CPU "
                  f"over every sweep ({ties} incumbent ties); wall "
                  f"{wall:.3f} s, {row['points_per_s']:.0f} points/s; segred "
                  f"launches {n_launch}; {smi_line}")
    return row


def phase_search(smi_line):
    """Brute force and multi-chain SA through ``optimise_mapping`` on the
    card at full width (tinyllama-1.1b / train_4k / V5E_POD)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    arch = get_arch("tinyllama-1.1b")
    shape = SHAPES_BY_NAME["train_4k"]
    runs = [_search_bf(req, arch, shape, smi_line) for req in SEARCH_BF]
    runs += [_search_sa(req["exec_model"], req["objective"], arch, shape,
                        smi_line) for req in REQUESTS]
    return runs, sum(r["segred_launches"] for r in runs)


def _lm_batch(vocab, batch, seq, seed):
    import torch
    from repro_torch.models import convert
    data = convert.recipe_batch(vocab, batch, seq, seed)
    return {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}


def _lm_record_check(phase, rec, kernel_mod, name):
    """(a) float32 weights from the seeded numpy recipe, the first layers
    at full width, held to the JAX package's record; ``kernel_mod`` is the
    wrapper module of kernel ``name`` whose ``LAUNCHES`` the forward must
    raise, once per layer in the forward and once more in the loss."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import convert
    from repro_torch.models.model import Model

    arch = get_arch(rec["arch"])
    model = Model(arch, layer_range=(0, rec["layers"]), use_flash=True,
                  device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    t0 = time.perf_counter()
    model.load_state_dict(convert.params_from_jax(
        convert.nest(convert.recipe_params(shapes, rec["seed"])),
        device="cuda", dtype=torch.float32), strict=True, assign=True)
    setup_s = time.perf_counter() - t0
    batch = _lm_batch(arch.vocab_size, rec["batch"], rec["seq"], rec["seed"])
    kernel_mod.LAUNCHES = 0
    logits, _ = model(batch)
    loss = float(model.loss(batch))
    torch.cuda.synchronize()
    launches = kernel_mod.LAUNCHES
    if launches != 2 * rec["layers"]:
        fail(f"{phase} (a): {launches} {name} launches, expected "
             f"{2 * rec['layers']} (forward and loss, one per layer)")
    loss_rel = abs(loss - rec["loss"]) / abs(rec["loss"])
    logit_err = max(abs(float(logits[b, t, v]) - want)
                    for b, t, v, want in rec["logits"])
    if not (loss_rel <= 1e-4 and logit_err <= 1e-3):
        fail(f"{phase} (a): loss {loss!r} vs JAX record {rec['loss']!r} (rel "
             f"{loss_rel:.3g}, limit 1e-4); sampled logits off by "
             f"{logit_err:.3g} (limit 1e-3)")
    say(phase, f"(a) {rec['arch']} layers 0-{rec['layers']} float32, "
               f"B={rec['batch']} T={rec['seq']}: loss {loss!r} vs JAX "
               f"record {rec['loss']!r} (rel {loss_rel:.3g}); sampled "
               f"logits max abs err {logit_err:.3g}; {name} launches "
               f"{launches}; recipe + copy {setup_s:.2f} s")
    return {"loss": loss, "loss_rel_err": loss_rel,
            "logit_max_abs_err": logit_err, "launches": launches,
            "setup_s": setup_s}


def _wkv_float64(r, k, v, w, u):
    """``ref.rwkv6``'s recurrence (zero initial state) summed in float64
    and rounded to r's dtype: the same function in a more exact order, the
    yardstick for what summation order alone does to the forward."""
    import torch
    B, T, H, hs = r.shape
    rd, kd, vd, wd = (x.double() for x in (r, k, v, w))
    ud = u.double()[None, :, :, None]
    S = torch.zeros((B, H, hs, hs), dtype=torch.float64, device=r.device)
    outs = []
    for t in range(T):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], S + ud * kv))
        S = wd[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype), S


def _attention_float64(q, k, v, *, causal=True, q_offset=0):
    """``ref.attention`` computed in float64 and rounded to q's dtype, one
    batch row at a time (the full-length score matrix of one row is 4.3 GB
    in float64 at [lm-dense] (b)'s shape): the same function in a more
    exact arithmetic."""
    import math

    import torch
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    out = torch.empty_like(q)
    for b in range(B):
        kd = torch.repeat_interleave(k[b].double(), group, dim=1)
        vd = torch.repeat_interleave(v[b].double(), group, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kd) / math.sqrt(dh)
        if causal:
            qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
            kpos = torch.arange(Skv, device=q.device)[None, :]
            s = s.masked_fill(~(kpos <= qpos), -torch.inf)
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                              vd).to(q.dtype)
        del kd, vd, s
    return out


def _logit_gap(a, b):
    """Max abs difference of two logits tensors, and the share of logits
    beyond 6e-2 abs and rel of ``b``."""
    af, bf = a.float(), b.float()
    diff = (af - bf).abs()
    return float(diff.max()), float((diff > 6e-2 + 6e-2 * bf.abs())
                                    .float().mean())


def _lm_full(phase, cfg, kernel_mod, entry, plain, oracle, oracle64,
             limit_used, limit_text, name):
    """(b): the full model in bfloat16 through the kernel, timed; every one
    of its kernel launches held to the plain version on the same inputs;
    its loss held to the same model with the plain oracle; its logits held
    to that model's, within LOGIT_YARDSTICK times that model's distance
    from the same model with the oracle ``ref.<oracle>`` replaced by
    ``oracle64`` (float64 arithmetic). ``kernel_mod.<entry>`` is the
    wrapper of kernel ``name`` that the model calls and ``plain`` its plain
    version; ``limit_used(got, want, args)`` is the largest share of the
    per-launch limit (``limit_text``) an output element uses."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.models.model import Model

    arch = get_arch(cfg["arch"])
    # what earlier phases keep on the card (the other LM, kept for the
    # profile) is not this forward's memory
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(arch, use_flash=True, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(cfg["seed"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.state_dict().values())
    batch = _lm_batch(arch.vocab_size, cfg["batch"], cfg["seq"], cfg["seed"])
    tokens = cfg["batch"] * cfg["seq"]

    model(batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    kernel_mod.LAUNCHES = 0
    for _ in range(cfg["runs"]):
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kernel_mod.LAUNCHES
    peak = torch.cuda.max_memory_allocated() - base
    per_forward = launches / cfg["runs"]
    if per_forward != arch.num_layers:
        fail(f"{phase} (b): {per_forward} {name} launches per forward, "
             f"expected {arch.num_layers}")

    # one more forward, each launch held to the plain version on its inputs
    kernel_call, layer_errs = getattr(kernel_mod, entry), []

    def held(*args, **kw):
        out = kernel_call(*args, **kw)
        # the largest share of the limit any element uses (<= 1 holds)
        layer_errs.append(limit_used(out, plain(*args, **kw), args))
        return out

    setattr(kernel_mod, entry, held)
    try:
        logits, _ = model(batch)
    finally:
        setattr(kernel_mod, entry, kernel_call)
    if len(layer_errs) != arch.num_layers or max(layer_errs) > 1.0:
        fail(f"{phase} (b): in-model {name} launches against the plain "
             f"version use {layer_errs} of the limit ({limit_text})")
    loss = float(model.loss(batch))

    plain_model = Model(arch, use_flash=False, device="meta")
    plain_model.load_state_dict(model.state_dict(), strict=True, assign=True)
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    want, _ = plain_model(batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    want_loss = float(plain_model.loss(batch))
    kept = getattr(ref, oracle)
    setattr(ref, oracle, oracle64)
    try:
        exact, _ = plain_model(batch)
    finally:
        setattr(ref, oracle, kept)
    if kernel_mod.LAUNCHES:
        fail(f"{phase} (b): the plain-{oracle} model launched the kernel")
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    finite = bool(torch.isfinite(logits.float()).all()) and loss == loss
    if logits.shape != (cfg["batch"], cfg["seq"], arch.vocab_size) or \
            not finite or loss_rel > 1e-3:
        fail(f"{phase} (b): logits {tuple(logits.shape)} finite={finite}; "
             f"loss {loss!r} vs plain-{oracle} {want_loss!r} (rel "
             f"{loss_rel:.3g}, limit 1e-3)")
    gaps = {"kernel_vs_plain": _logit_gap(logits, want),
            "plain_vs_float64": _logit_gap(want, exact),
            "kernel_vs_float64": _logit_gap(logits, exact)}
    # the yardstick: how far a more exact arithmetic alone moves these logits
    logit_limit = LOGIT_YARDSTICK * gaps["plain_vs_float64"][0]
    if not gaps["kernel_vs_plain"][0] <= logit_limit:
        fail(f"{phase} (b): logits {gaps['kernel_vs_plain'][0]:.3g} from the "
             f"plain-{oracle} forward's, beyond {LOGIT_YARDSTICK} times the "
             f"plain forward's distance from its float64 {oracle} "
             f"({gaps['plain_vs_float64'][0]:.3g})")
    mean_wall = sum(walls) / len(walls)
    out = {"arch": cfg["arch"], "params": n_params, "init_s": init_s,
           "batch": cfg["batch"], "seq": cfg["seq"], "walls_s": walls,
           "tokens_per_s": tokens / mean_wall, "launches": launches,
           "launches_per_forward": per_forward, "peak_bytes": peak,
           "layer_limit_used": layer_errs,
           "loss": loss, "plain_loss": want_loss, "loss_rel_err": loss_rel,
           "logit_gaps": gaps, "logit_limit": logit_limit,
           "plain_wall_s": plain_wall}
    say(phase, f"(b) {cfg['arch']}, {arch.num_layers} layers, {n_params} "
               f"parameters bfloat16 (drawn on the card in {init_s:.2f} s), "
               f"B={cfg['batch']} T={cfg['seq']}: wall per forward "
               f"{', '.join(f'{w:.4f}' for w in walls)} s, "
               f"{out['tokens_per_s']:.0f} tokens/s; {name} launches "
               f"{launches} in {cfg['runs']} forwards ({per_forward:.0f} per "
               f"forward); peak memory {peak / 2**30:.2f} GiB (weights "
               f"included)")
    say(phase, f"(b) each of the {len(layer_errs)} in-model {name} launches "
               f"holds its plain version on the same inputs, using at most "
               f"{max(layer_errs):.3g} of the limit ({limit_text}); "
               f"loss {loss!r} vs plain-{oracle} forward {want_loss!r} "
               f"(rel {loss_rel:.3g}, limit 1e-3; plain forward "
               f"{plain_wall:.2f} s)")
    say(phase, "(b) logits, max abs diff / share beyond 6e-2 abs and rel: " +
        "; ".join(f"{k.replace('_', ' ')} {v[0]:.3g} / {v[1]:.3g}"
                  for k, v in gaps.items()) +
        f"; kernel vs plain held within {logit_limit:.3g} "
        f"({LOGIT_YARDSTICK} x plain vs float64)")
    del plain_model, want, exact
    return model, batch, out


def _lm_float32(phase, cfg, model, batch, kernel_mod, name):
    """(c): the (b) model's weights cast to float32; the whole forward
    through the kernel against the same forward with the plain version,
    both in float32: logits within LM_F32_LOGIT_TOL abs and rel, loss
    within LM_F32_LOSS_TOL relative, one launch per layer."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    arch = get_arch(cfg["arch"])
    weights = {k: t.float() for k, t in model.state_dict().items()}
    kernel_model = Model(arch, use_flash=True, device="meta")
    kernel_model.load_state_dict(weights, strict=True, assign=True)
    plain_model = Model(arch, use_flash=False, device="meta")
    plain_model.load_state_dict(weights, strict=True, assign=True)
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    logits, _ = kernel_model(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_mod.LAUNCHES
    loss = float(kernel_model.loss(batch))
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    want, _ = plain_model(batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    want_loss = float(plain_model.loss(batch))
    if kernel_mod.LAUNCHES:
        fail(f"{phase} (c): the plain float32 model launched the kernel")
    diff = (logits - want).abs()
    used = float((diff / (LM_F32_LOGIT_TOL * (1 + want.abs()))).max())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    if logits.dtype != torch.float32 or launches != arch.num_layers or \
            not bool(torch.isfinite(logits).all()) or not used <= 1.0 or \
            not loss_rel <= LM_F32_LOSS_TOL:
        fail(f"{phase} (c): float32 {logits.dtype}, {launches} {name} "
             f"launches (expected {arch.num_layers}); logits "
             f"{float(diff.max()):.3g} from the plain forward's ({used:.3g} "
             f"of {LM_F32_LOGIT_TOL} abs and rel); loss {loss!r} vs "
             f"{want_loss!r} (rel {loss_rel:.3g}, limit {LM_F32_LOSS_TOL})")
    out = {"launches": launches, "logit_max_abs_err": float(diff.max()),
           "logit_limit_used": used, "loss": loss, "plain_loss": want_loss,
           "loss_rel_err": loss_rel, "wall_s": wall, "plain_wall_s": plain_wall}
    say(phase, f"(c) {cfg['arch']}, {arch.num_layers} layers, the (b) weights "
               f"in float32, B={cfg['batch']} T={cfg['seq']}: logits max abs "
               f"diff {out['logit_max_abs_err']:.3g} from the plain-{name} "
               f"float32 forward ({used:.3g} of {LM_F32_LOGIT_TOL} abs and "
               f"rel); loss {loss!r} vs {want_loss!r} (rel {loss_rel:.3g}, "
               f"limit {LM_F32_LOSS_TOL}); {launches} {name} launches; wall "
               f"{wall:.3f} s (plain {plain_wall:.2f} s)")
    del kernel_model, plain_model, weights, logits, want, diff
    return out


def phase_lm():
    """rwkv6-1.6b: (a) against the JAX record, (b) the full model with the
    WKV kernel, held to the plain-WKV model and a float64 recurrence."""
    import torch
    from repro_torch.kernels import rwkv6_scan
    record = _lm_record_check("lm", LM_RECORD, rwkv6_scan, "wkv6")
    torch.cuda.empty_cache()
    model, batch, out = _lm_full("lm", LM_FULL, rwkv6_scan, "wkv6",
                                 rwkv6_scan.wkv6_plain, "rwkv6",
                                 _wkv_float64,
                                 lambda got, want, args: _wkv_limit_used(
                                     got, want),
                                 f"{WKV_TOL['bfloat16']} abs and rel; one "
                                 f"bfloat16 rounding step", "wkv6")
    out["record"] = record
    torch.cuda.empty_cache()
    out["float32"] = _lm_float32("lm", LM_FULL, model, batch, rwkv6_scan,
                                 "wkv6")
    torch.cuda.empty_cache()
    return model, batch, out


def phase_lm_dense():
    """tinyllama-1.1b: (a) against the JAX record, (b) the full model with
    flash attention in the kernel, held to the ``attn_impl="ref"`` model
    and to attention in float64."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    record = _lm_record_check("lm-dense", DENSE_RECORD, fa, "flash_attn")
    torch.cuda.empty_cache()
    model, batch, out = _lm_full("lm-dense", DENSE_FULL, fa,
                                 "flash_attention", fa.flash_attention_plain,
                                 "attention", _attention_float64,
                                 lambda got, want, args: _flash_limit_used(
                                     got, want, args[2]),
                                 f"{FLASH_TOL['bfloat16']} abs and rel; one "
                                 f"bfloat16 rounding step", "flash_attn")
    out["record"] = record
    torch.cuda.empty_cache()
    return model, batch, out


def _profile(fn):
    """Device events of ``fn()`` under torch.profiler, summed by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total, cnt + 1)
    return wall, dev, by_name


def _top(by_name, n=8):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:120], "device_s": v[0] * 1e-6, "count": v[1]}
            for k, v in top]


def phase_profile_lm(phase, model, batch, lm, kernel):
    """One LM forward under torch.profiler: device busy time, the idle
    share, the share of the kernel whose name holds ``kernel``, and the top
    kernels."""
    wall, dev, by_name = _profile(lambda: model(batch))
    device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
    plain_wall = min(lm["walls_s"])
    out = {"profiled_wall_s": wall, "wall_s": plain_wall,
           "device_s": device_s, "device_events": len(dev),
           "idle_share": (1.0 - device_s / plain_wall) if dev else None,
           "top": _top(by_name)}
    if not dev:
        say("profile", f"{phase}: the profiler traced no device activity: "
                       f"device time not measured")
        return out
    hits = [v for k, v in by_name.items() if kernel in k]
    out["kernel"] = kernel
    out["kernel_device_s"] = sum(v[0] for v in hits) * 1e-6
    out["kernel_events"] = sum(v[1] for v in hits)
    out["kernel_share"] = out["kernel_device_s"] / device_s
    say("profile", f"{phase} forward: {len(dev)} device events, device busy "
                   f"{device_s:.4f} s of {plain_wall:.4f} s wall (idle share "
                   f"{out['idle_share']:.4f}); {kernel} "
                   f"{out['kernel_device_s']:.5f} s in "
                   f"{out['kernel_events']} launches = "
                   f"{out['kernel_share']:.4f} of device time")
    for row in out["top"]:
        say("profile", f"  {row['device_s']:.5f} s  x{row['count']}  "
                       f"{row['name']}")
    return out


def _is_segred(name):
    """Whether a traced kernel is one of segred's (``segred_kernel``,
    ``segred_output_kernel``, or the first design's ``segred_kernel``)."""
    return "segred" in name and "kernel" in name


def phase_profile_segred(yardsticks):
    """segred's device time a launch under torch.profiler, beside its first
    design's, float32, at the mapper's shape and a brute-force chunk's: 100
    launches of each, in separate traces (the first design's kernel is
    named segred_kernel too). This separates the kernels from the host
    work that sets the CUDA-event time of a call at 28 rows."""
    import torch
    from repro_torch.core.accel import segred
    first = yardsticks["segred"]["float32"]
    rows = []
    for N, n in SEGRED_SHAPES[:2]:
        vals, pid = _segred_inputs(N, n, torch.float32, seed=N + n)
        for op in ("max", "sum"):
            us = {}
            for design, fn in (
                    ("kernel", lambda: segred.segmented_reduce(vals, pid, op)),
                    ("first design",
                     lambda: _segred_first(first, vals, pid, op))):
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                _, dev, by_name = _profile(
                    lambda: [fn() for _ in range(100)])
                hits = [v for k, v in by_name.items() if _is_segred(k)]
                count = sum(v[1] for v in hits)
                us[design] = (sum(v[0] for v in hits) / count) if count \
                    else None
            row = {"N": N, "n": n, "dtype": "float32", "op": op,
                   "device_us": us["kernel"],
                   "first_design_device_us": us["first design"]}
            rows.append(row)
            if us["kernel"] is None or us["first design"] is None:
                say("profile", f"segred {op} [{N},{n}]: the profiler traced "
                               f"no segred launch: device time not measured")
                continue
            say("profile", f"segred {op} float32 [{N},{n}]: device "
                           f"{us['kernel']:.3f} us a launch, first design "
                           f"{us['first design']:.3f} us (100 launches each)")
    return rows


def phase_profile(runs):
    """The first request once more under torch.profiler. Device time is the
    sum of the traced kernel and copy durations (one stream, so they do not
    overlap); the idle share is one minus that over the unprofiled wall
    time of the same request in phase 4."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import V5E_POD

    req = REQUESTS[0]
    wall, dev, by_name = _profile(lambda: optimise_mapping(
        get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"], V5E_POD,
        optimiser="rule_based", objective=req["objective"],
        exec_model=req["exec_model"], engine="torch"))
    device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
    plain_wall = runs[0]["wall_s"]
    out = {"request": runs[0]["request"], "profiled_wall_s": wall,
           "wall_s": plain_wall, "device_s": device_s,
           "device_events": len(dev),
           "idle_share": (1.0 - device_s / plain_wall) if dev else None,
           "top": _top(by_name)}
    if not dev:
        say("profile", "the profiler traced no device activity: device "
                       "time not measured")
        return out
    seg = [v for k, v in by_name.items() if _is_segred(k)]
    out["segred_device_s"] = sum(v[0] for v in seg) * 1e-6
    out["segred_events"] = sum(v[1] for v in seg)
    if not out["segred_events"]:
        fail("the profiler traced the request's device work but no segred "
             "launch, though its counter saw them")
    say("profile", f"{out['request']}: {len(dev)} device events, device busy "
                   f"{device_s:.4f} s of {plain_wall:.3f} s wall (idle share "
                   f"{out['idle_share']:.4f}); profiled wall {wall:.3f} s; "
                   f"segred kernel {out['segred_device_s']:.5f} s device "
                   f"time in {out['segred_events']} launches")
    for row in out["top"]:
        say("profile", f"  {row['device_s']:.5f} s  x{row['count']}  "
                       f"{row['name']}")
    return out


def phase_profile_search(search):
    """Brute force (a) and (b) and SA on spmd/latency once more under
    torch.profiler: device busy time, its idle share against the
    unprofiled wall time of the same request in phase 5, and segred's
    device time."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import V5E_POD
    arch, shape = get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"]
    sa_req = REQUESTS[1]
    calls = [(search[i], dict(optimiser="brute_force", backend=req["backend"],
                              objective=req["objective"],
                              exec_model=req["exec_model"], **req["kw"]))
             for i, req in enumerate(SEARCH_BF)]
    sa_tag = f"spmd {sa_req['exec_model']}/{sa_req['objective']}"
    calls.append((next(r for r in search if r["request"].startswith("(c)")
                       and r["request"].endswith(sa_tag)),
                  dict(optimiser="annealing", backend=SEARCH_SA["backend"],
                       objective=sa_req["objective"],
                       exec_model=sa_req["exec_model"],
                       chains=SEARCH_SA["chains"],
                       seed=SEARCH_SA["seeds"][0])))
    out = []
    for row, kw in calls:
        wall, dev, by_name = _profile(lambda: optimise_mapping(
            arch, shape, V5E_POD, engine="torch", **kw))
        device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
        seg = [v for k, v in by_name.items() if _is_segred(k)]
        rec = {"request": row["request"], "profiled_wall_s": wall,
               "wall_s": row["wall_s"], "device_s": device_s,
               "device_events": len(dev),
               "idle_share": (1.0 - device_s / row["wall_s"]) if dev
               else None,
               "segred_device_s": sum(v[0] for v in seg) * 1e-6,
               "segred_events": sum(v[1] for v in seg), "top": _top(by_name)}
        out.append(rec)
        if not dev:
            say("profile", f"{row['request']}: the profiler traced no device "
                           f"activity: device time not measured")
            continue
        say("profile", f"{row['request']}: {len(dev)} device events, device "
                       f"busy {device_s:.4f} s of {row['wall_s']:.3f} s wall "
                       f"(idle share {rec['idle_share']:.4f}); profiled wall "
                       f"{wall:.3f} s; segred {rec['segred_device_s']:.5f} s "
                       f"in {rec['segred_events']} launches")
        for top in rec["top"]:
            say("profile", f"  {top['device_s']:.5f} s  x{top['count']}  "
                           f"{top['name']}")
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    kind, smi_line = phase_device()
    import torch
    build, yardsticks = phase_build()
    rows = phase_kernels(yardsticks)
    wkv_rows = phase_wkv6(yardsticks)
    flash_rows = phase_flash()
    runs, launches = phase_main()
    search, search_launches = phase_search(smi_line)
    model, batch, lm = phase_lm()
    dense_model, dense_batch, dense = phase_lm_dense()
    profiled = None
    if "--profile" in sys.argv[1:]:
        profiled = {"mapping": phase_profile(runs),
                    "search": phase_profile_search(search),
                    "segred": phase_profile_segred(yardsticks),
                    "lm": phase_profile_lm("lm", model, batch, lm,
                                           "wkv6_chunk_kernel"),
                    "lm-dense": phase_profile_lm("lm-dense", dense_model,
                                                 dense_batch, dense,
                                                 "flash_attn_mma_kernel")}

    main_row = next(r for r in rows if (r["N"], r["n"]) == SEGRED_SHAPES[0]
                    and r["dtype"] == "float32" and r["op"] == "max")
    lm_row = next(r for r in wkv_rows
                  if tuple(r["shape"]) == WKV_LM_SHAPE)
    dense_row = next(r for r in flash_rows
                     if tuple(r["shape"]) == FLASH_LM_SHAPE
                     and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "segred", "route": "cuda",
        "source": "src/repro_torch/csrc/segred.cu",
        "replaces": "src/repro/core/accel/pallas_segred.py:31",
        "launches": launches + search_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:27",
        "launches": lm["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        "ms": lm_row["ms"], "plain_ms": lm_row["plain_ms"],
        "bound_ms": lm_row["bound_ms"], "bound_by": lm_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": dense["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": dense_row["ms"], "plain_ms": dense_row["plain_ms"],
        "bound_ms": dense_row["bound_ms"], "bound_by": dense_row["bound_by"],
        "library_ms": dense_row["library_ms"],
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build": {name: {k: info[k] for k in ("seconds", "cached", "ptxas")}
                  for name, info in build.items()},
        "segred": rows, "wkv6": wkv_rows, "flash_attn": flash_rows,
        "main": runs, "search": search, "lm": lm, "lm_dense": dense,
        "profile": profiled, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
